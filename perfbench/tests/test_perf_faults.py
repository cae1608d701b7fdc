"""A run with the timed path broken underneath must come out not correct.

Each case drives a whole run on the CPU (the harness's look for a card
skipped) with one fault planted in the renderer. The faults a cell of
this benchmark can have: a step that returns its state unchanged (the
film never takes a sample), half of the batch left out (half of each
tile's pixels unrendered), an answer altered where it is produced (every
path's radiance 1% off). No cell spans cards, so there is no exchange
between them to leave out."""
import pytest

from perfbench.bench import harness

from conftest import tiny

CELLS = ["sphere135k.final1024", "sphere135k.preview256"]
FAULTS = ["state_unchanged", "half_batch", "answer_altered"]


def plant(fault: str, monkeypatch):
    from pbrt_tpu_torch.film import film
    from pbrt_tpu_torch.integrators import surface
    from pbrt_tpu_torch.renderers import driver

    if fault == "state_unchanged":
        monkeypatch.setattr(film, "add_samples", lambda film_, state, *a, **kw: state)
    elif fault == "half_batch":
        real = driver.render_tile

        def render_tile(scene, film_, camera, sampler, li_fn, state, pix_ids, seed, n_real=None):
            half = pix_ids.shape[0] // 2
            return real(scene, film_, camera, sampler, li_fn, state, pix_ids[:half], seed,
                        None if n_real is None else min(n_real, half))
        monkeypatch.setattr(driver, "render_tile", render_tile)
    else:
        real_li = surface.li_path
        monkeypatch.setattr(surface, "li_path", lambda *a, **kw: real_li(*a, **kw) * 1.01)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    seed = 2**31 + 99
    ok = harness.run_cell(cell, seed, 0.2, False, device="cpu", overrides=tiny(cell))
    assert ok["correct"], ok["check"]
    plant(fault, monkeypatch)
    r = harness.run_cell(cell, seed, 0.2, False, device="cpu", overrides=tiny(cell))
    assert not r["correct"], r["check"]
