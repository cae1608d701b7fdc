"""Photon maps as sorted uniform grids with blocked kNN.

Port of pbrt_tpu/photon/map.py (in place of the reference's
KdTree<Photon> + ClosePhoton max-heap kNN, reference core/kdtree.h:63-186,
core/photonshooter.h:186-203): photons are sorted by the id of their
uniform-grid cell, a cell's photons are found through prefix offsets, and
a lookup gathers the 3x3x3 neighbouring cells (at most `cap` photons
each), computes squared distances and keeps the k smallest — fixed
shapes, no heap, batched over query points.

Layout and blocking, chosen for the GPU (the JAX package's [P, 4]
packing, transposed [S, P] spectra and 96 MB block rule serve the TPU's
128-lane tiles and are not carried over):
  * positions and directions are [P, 3] float32 and the spectra [P, S]
    row-major: a gathered photon's spectrum is one contiguous 120-byte
    row, so the [B, K] gathers read whole sectors;
  * a lookup first probes the 27 cells of every query (a [Q, 27] gather
    of the offsets) and keeps only the queries whose neighbourhood holds
    a photon (and that the caller marks as wanted). That is the JAX
    package's `compact` live-first partition and its skip of empty
    blocks in one step; it costs one host sync per lookup, for the
    number of live queries;
  * the live queries run in blocks sized from the memory a block's
    temporaries take (candidate ids, coordinates, keys and the gathered
    [B, K, S] spectra, per query about M * 33 + K * (4 S + 24) bytes for
    M = 27 cap candidates) against a budget of 1/16 of the card's free
    memory, at most 2 GiB (64 MiB on the CPU). [Q, K, S] is never held
    for all queries at once.

Top-k ties: the k nearest are chosen on int64 keys (the distance's
float32 bits << 32 | candidate position), so a tie in distance goes to
the earlier candidate, as lax.top_k does: duplicate positions and
photons on cell boundaries select the same set, in the same order.

The density-estimate normalization is the reference kd-tree's
(core/photonshooter.cpp:17-35 EPhoton, integrators/photonmap.cpp
LPhoton): r2_norm is the shrunk maxDist2 — the kth-nearest distance once
k photons are found, else the caller's maxDist2. r2_found is the found
set's largest distance (the volume estimate's cell). For a query whose
27 cells hold no photon both are max_dist2; for one whose cells hold
photons none of which lies within max_dist2, r2_found is 1e-12. The JAX
package gives such a query either value, depending on its block's other
queries; it finds no photon there either way, and no estimate reads
r2_found without photons.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec

S = spec.N_BINS

# the 27 neighbour offsets (dx, dy, dz) in the JAX package's order: z
# outermost, x innermost
_OFFSETS = np.array([(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dx in (-1, 0, 1)], np.int64)


class PhotonMap(NamedTuple):
    pos: torch.Tensor         # [P, 3] sorted by cell id
    alpha: torch.Tensor       # [P, S] photon power
    wi: torch.Tensor          # [P, 3] incident directions
    cell_start: torch.Tensor  # [C + 1] int64 prefix offsets
    grid_lo: torch.Tensor     # [3]
    inv_cell: torch.Tensor    # [3] cells per unit length
    dims: Tuple[int, int, int]
    count: int
    occ: Optional[torch.Tensor] = None  # [P] occupancy of each photon's cell: a
    # lookup that truncates a cell to `cap` candidates weights each by
    # occ / cap (the candidates are a uniform subsample of the cell)


class MapStructure(NamedTuple):
    """Host-computed sorted-grid structure (the discrete part of a map)."""

    order: np.ndarray        # [P] photon sort order
    cell_start: np.ndarray   # [C + 1]
    occ: np.ndarray          # [P] cell occupancy (sorted order)
    lo: np.ndarray           # [3]
    inv_cell: np.ndarray     # [3]
    dims: Tuple[int, int, int]


def photon_map_structure(pos: np.ndarray, cell_size: float,
                         target_k: int = 0) -> Optional[MapStructure]:
    """Host: bucket photons on a uniform grid of `cell_size` (about the
    query maxdist, so the 3x3x3 neighbourhood covers the search radius).
    target_k > 0 grows the cell until a neighbourhood holds ~2 target_k
    photons on average (large `nused` stays serviceable from 27 cells).
    The total cell count, not each axis, is capped at 1 << 24."""
    P = len(pos)
    if P == 0:
        return None
    pos = np.asarray(pos, np.float32)
    lo = pos.min(0) - 1e-4
    hi = pos.max(0) + 1e-4
    cell = max(float(cell_size), 1e-6)
    if target_k > 0:
        vol = float(np.prod(np.maximum(hi - lo, 1e-6)))
        # 27 c^3 (P/V) >= 2k  =>  c >= (2 k V / (27 P))^(1/3)
        c_dens = (2.0 * target_k * vol / (27.0 * max(P, 1))) ** (1.0 / 3.0)
        cell = max(cell, c_dens)
    dims = np.maximum(1, np.ceil((hi - lo) / cell)).astype(np.int64)
    max_cells = 1 << 24
    while int(np.prod(dims)) > max_cells:
        dims = np.maximum(1, dims // 2)
    inv_cell = dims / np.maximum(hi - lo, 1e-12)  # cells per unit
    cx = np.clip(((pos - lo) * inv_cell).astype(np.int64), 0, dims - 1)
    cid = (cx[:, 2] * dims[1] + cx[:, 1]) * dims[0] + cx[:, 0]
    order = np.argsort(cid, kind="stable")
    cid_s = cid[order]
    C = int(dims[0] * dims[1] * dims[2])
    cell_start = np.searchsorted(cid_s, np.arange(C + 1)).astype(np.int32)
    occ_p = np.bincount(cid_s, minlength=C)[cid_s].astype(np.float32)
    return MapStructure(order=order, cell_start=cell_start, occ=occ_p,
                        lo=lo.astype(np.float32), inv_cell=inv_cell.astype(np.float32),
                        dims=(int(dims[0]), int(dims[1]), int(dims[2])))


def build_photon_map_from(st: MapStructure, pos, alpha, wi, device) -> PhotonMap:
    """Assemble a PhotonMap over a fixed structure; pos [P, 3], alpha
    [P, S] and wi [P, 3] may be NumPy arrays or tensors (on any device)."""
    order = torch.as_tensor(st.order, device=device)

    def sorted_rows(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device)[order].contiguous()

    return PhotonMap(
        pos=sorted_rows(pos), alpha=sorted_rows(alpha), wi=sorted_rows(wi),
        cell_start=torch.as_tensor(st.cell_start.astype(np.int64), device=device),
        grid_lo=torch.as_tensor(st.lo, device=device),
        inv_cell=torch.as_tensor(st.inv_cell, device=device),
        dims=st.dims, count=len(st.order),
        occ=torch.as_tensor(st.occ, device=device))


def build_photon_map(pos, alpha, wi, cell_size: float, target_k: int = 0,
                     device=None) -> Optional[PhotonMap]:
    """Host structure + payload in one step, on `device` (default: pos's
    device for a tensor, the card for a NumPy array)."""
    if device is None:
        device = pos.device if isinstance(pos, torch.Tensor) else "cuda"
    pos_np = pos.cpu().numpy() if isinstance(pos, torch.Tensor) else np.asarray(pos)
    st = photon_map_structure(pos_np, cell_size, target_k)
    if st is None:
        return None
    return build_photon_map_from(st, pos, alpha, wi, device)


# ---------------------------------------------------------------------------
# Candidates and the top-k phase

def _cells(pm, q):
    """Clamped cell coordinates of each query [B] x 3 (int64)."""
    cq = torch.nan_to_num((q - pm.grid_lo) * pm.inv_cell)
    return [torch.clamp(torch.floor(cq[:, a]), 0, pm.dims[a] - 1).long() for a in range(3)]


def _neighbour_cells(pm, q):
    """([B, 27] cell ids, [B, 27] in-grid flags) of each query's 3x3x3
    neighbourhood."""
    nx, ny, nz = pm.dims
    off = torch.as_tensor(_OFFSETS, device=q.device)
    cx, cy, cz = _cells(pm, q)
    x = cx[:, None] + off[:, 0]
    y = cy[:, None] + off[:, 1]
    z = cz[:, None] + off[:, 2]
    inb = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
    cid = ((torch.clamp(z, 0, nz - 1) * ny + torch.clamp(y, 0, ny - 1)) * nx
           + torch.clamp(x, 0, nx - 1))
    return cid, inb


def candidate_count(pm, q):
    """Photons in the 27-cell neighbourhood of each query [Q] (a cheap
    [Q, 27] probe of the offsets)."""
    cid, inb = _neighbour_cells(pm, q)
    cnt = pm.cell_start[cid + 1] - pm.cell_start[cid]
    return torch.sum(torch.where(inb, cnt, torch.zeros((), dtype=cnt.dtype, device=q.device)), 1)


def _gather_candidates(pm, q, cap: int):
    """Candidate photon ids from the 3x3x3 neighbourhood of each query:
    ([B, 27 cap] ids, [B, 27 cap] validity). Cells denser than `cap` are
    truncated to their first `cap` photons (build order: spatially random
    within the cell); the lookups correct with the cell occupancy."""
    cid, inb = _neighbour_cells(pm, q)
    start, end = pm.cell_start[cid], pm.cell_start[cid + 1]           # [B, 27]
    idx = start[:, :, None] + torch.arange(cap, device=q.device)       # [B, 27, cap]
    ok = inb[:, :, None] & (idx < end[:, :, None])
    B = q.shape[0]
    return (torch.clamp(idx, 0, pm.count - 1).reshape(B, -1), ok.reshape(B, -1))


def default_cap(k: int) -> int:
    # at least 24 a cell: a larger cap lowers the variance of the
    # truncation correction and tightens the found-set radius for big k
    return max(24, -(-4 * k // 27))


def _sq_dist(cand, qb):
    return ((cand[..., 0] - qb[:, 0:1]) ** 2 + (cand[..., 1] - qb[:, 1:2]) ** 2
            + (cand[..., 2] - qb[:, 2:3]) ** 2)


class TopK(NamedTuple):
    gi: torch.Tensor        # [B, K] photon ids (sorted order of the map)
    d2: torch.Tensor        # [B, K] squared distances, ascending (inf: not found)
    valid: torch.Tensor     # [B, K]
    r2_norm: torch.Tensor   # [B]
    r2_found: torch.Tensor  # [B]
    n_found: torch.Tensor   # [B] int64
    invf: torch.Tensor      # [B, K] inverse inclusion fraction (>= 1)


def topk_phase(pm, qb, k: int, max_dist2: float, cap: int) -> TopK:
    """Distances only, for one block: the k nearest candidates within
    max_dist2, nearest first, ties to the earlier candidate."""
    idx, ok = _gather_candidates(pm, qb, cap)                    # [B, M]
    d2 = _sq_dist(pm.pos[idx], qb)
    inf = torch.full((), float("inf"), device=qb.device)
    d2 = torch.where(ok & (d2 <= max_dist2), d2, inf)
    M = d2.shape[1]
    k_eff = min(k, M)
    # d2 >= 0 (or +inf): its float32 bits order as its value
    keys = (d2.view(torch.int32).to(torch.int64) << 32) | torch.arange(M, device=qb.device)
    top_m = torch.topk(keys, k_eff, dim=1, largest=False, sorted=True).indices
    d2k = torch.gather(d2, 1, top_m)
    valid = torch.isfinite(d2k)
    gi = torch.gather(idx, 1, top_m)
    if pm.occ is not None:
        invf = torch.clamp(pm.occ[gi] / float(cap), min=1.0)
    else:
        invf = torch.ones_like(d2k)
    n_found = torch.sum(valid, 1)
    kth = torch.amax(torch.where(valid, d2k, torch.zeros((), device=qb.device)), 1)
    r2_norm = torch.where(n_found >= k_eff, kth, torch.full((), max_dist2, device=qb.device))
    return TopK(gi, d2k, valid, torch.clamp(r2_norm, min=1e-12), torch.clamp(kth, min=1e-12),
                n_found, invf)


# ---------------------------------------------------------------------------
# Blocking over live queries

BLOCK_BUDGET_CUDA = 2 << 30   # bytes of temporaries per block, at most
BLOCK_BUDGET_CPU = 64 << 20


def query_block(k: int, cap: int, device) -> int:
    """Queries per block, from the bytes one query's temporaries take."""
    per_query = 27 * cap * 33 + max(k, 1) * (4 * S + 24)
    if torch.device(device).type == "cuda":
        free, _ = torch.cuda.mem_get_info(torch.device(device))
        budget = min(BLOCK_BUDGET_CUDA, free // 16)
    else:
        budget = BLOCK_BUDGET_CPU
    return int(max(256, min(1 << 17, budget // per_query)))


def live_queries(pm, q, mask=None):
    """Ids of the queries whose neighbourhood holds a photon (and that
    `mask` keeps), as one host-synced nonzero."""
    live = candidate_count(pm, q) > 0
    if mask is not None:
        live = live & mask
    with probes.scope("sync/knn_live"):
        return torch.nonzero(live).squeeze(1)


class FluxResult(NamedTuple):
    flux: torch.Tensor      # [Q, S] (or [Q, W, S] for W weight channels)
    n_found: torch.Tensor   # [Q] int64
    r2_norm: torch.Tensor   # [Q] shrunk kernel radius (surface contract)
    r2_found: torch.Tensor  # [Q] found-set max dist2 (volume contract)
    n_live: torch.Tensor    # [] int64 on the host: the queries searched (live_queries)


def knn_weighted_flux(pm: Optional[PhotonMap], q, k: int, max_dist2: float, weight_fn,
                      extras=(), mask=None, n_channels: int = 0, block: int = 0) -> FluxResult:
    """Fused kNN density estimate: flux[q] = sum_k w_k * alpha_k.

    weight_fn(wix, wiy, wiz, d2, valid, r2_norm, *extras_block) returns
    per-photon weights [B, K], or [B, K, W] for W channels (n_channels =
    W, giving flux [Q, W, S]). extras: tensors with leading dim Q.
    mask [Q] bool: queries whose estimate the caller reads (others get
    the no-photon result)."""
    Q = q.shape[0]
    dev = q.device
    fshape = (Q, n_channels, S) if n_channels else (Q, S)
    out = FluxResult(flux=torch.zeros(fshape, device=dev),
                     n_found=torch.zeros((Q,), dtype=torch.int64, device=dev),
                     r2_norm=torch.full((Q,), max(max_dist2, 1e-12), device=dev),
                     r2_found=torch.full((Q,), max(max_dist2, 1e-12), device=dev),
                     n_live=torch.zeros((), dtype=torch.int64))
    if pm is None or Q == 0:
        return out
    cap = default_cap(k)
    live = live_queries(pm, q, mask)
    out = out._replace(n_live=torch.tensor(live.shape[0]))
    block = block or query_block(k, cap, dev)
    for s in range(0, live.shape[0], block):
        ids = live[s:s + block]
        qb = q[ids]
        tk = topk_phase(pm, qb, k, max_dist2, cap)
        wsel = pm.wi[tk.gi]                                          # [B, K, 3]
        w = weight_fn(wsel[..., 0], wsel[..., 1], wsel[..., 2], tk.d2, tk.valid,
                      tk.r2_norm, *(e[ids] for e in extras))
        A = pm.alpha[tk.gi]                                          # [B, K, S]
        zero = torch.zeros((), device=dev)
        if w.dim() == 3:
            w = torch.where(tk.valid[..., None], w * tk.invf[..., None], zero)
            flux = torch.einsum("bks,bkw->bws", A, w)
        else:
            w = torch.where(tk.valid, w * tk.invf, zero)
            flux = torch.einsum("bks,bk->bs", A, w)
        out.flux[ids] = flux
        out.n_found[ids] = tk.n_found
        out.r2_norm[ids] = tk.r2_norm
        out.r2_found[ids] = tk.r2_found
    return out


def knn_dirs(pm: Optional[PhotonMap], q, k: int, max_dist2: float, mask=None):
    """Directions of the k nearest photons (final-gather photon-cone
    importance sampling), nearest first: (wix, wiy, wiz, valid), each
    [Q, K]; zeros and False where none is found."""
    Q = q.shape[0]
    dev = q.device
    wi = torch.zeros((Q, k, 3), device=dev)
    valid = torch.zeros((Q, k), dtype=torch.bool, device=dev)
    if pm is not None and Q:
        cap = default_cap(k)
        live = live_queries(pm, q, mask)
        block = query_block(k, cap, dev)
        for s in range(0, live.shape[0], block):
            ids = live[s:s + block]
            tk = topk_phase(pm, q[ids], k, max_dist2, cap)
            wi[ids] = pm.wi[tk.gi]
            valid[ids] = tk.valid
    return wi[..., 0], wi[..., 1], wi[..., 2], valid


class KnnResult(NamedTuple):
    alpha: torch.Tensor   # [Q, K, S]
    wi: torch.Tensor      # [Q, K, 3]
    dist2: torch.Tensor   # [Q, K]
    valid: torch.Tensor   # [Q, K]
    r2_max: torch.Tensor  # [Q] kth dist2 once k are found, else max_dist2


def knn_lookup(pm: PhotonMap, q, k: int, max_dist2: float) -> KnnResult:
    """Materialized k-nearest lookup, for tests and small query sets
    (renders use knn_weighted_flux / knn_dirs)."""
    cap = default_cap(k)
    tk = topk_phase(pm, q, k, max_dist2, cap)
    zero = torch.zeros((), device=q.device)
    alpha = pm.alpha[tk.gi] * tk.invf[..., None]
    return KnnResult(alpha=torch.where(tk.valid[..., None], alpha, zero), wi=pm.wi[tk.gi],
                     dist2=torch.where(tk.valid, tk.d2, zero), valid=tk.valid,
                     r2_max=tk.r2_norm)


def ephoton(pm: Optional[PhotonMap], q, n, k: int, max_dist2: float, mask=None):
    """Irradiance at (q, n) (reference core/photonshooter.cpp EPhoton
    :17-35): the power of the k nearest photons with dot(n, wi) > 0 over
    (r2_norm pi); the map's powers are already 1/nshot-normalized. [Q, S]."""
    if pm is None:
        return torch.zeros(q.shape[:-1] + (S,), device=q.device)

    def weight(wix, wiy, wiz, d2, valid, r2, nb):
        front = wix * nb[:, 0:1] + wiy * nb[:, 1:2] + wiz * nb[:, 2:3] > 0.0
        return front.to(torch.float32)

    res = knn_weighted_flux(pm, q, k, max_dist2, weight, extras=(n,), mask=mask)
    return res.flux / (res.r2_norm[..., None] * math.pi)


class RadianceMap(NamedTuple):
    """Radiance photons (reference photonshooter.h:30-37 {p, n, Lo}) on
    the same sorted grid; queried by the nearest photon whose normal
    faces the query's hemisphere (RadiancePhotonProcess, :63-77)."""

    pos: torch.Tensor         # [P, 3] sorted by cell id
    lo: torch.Tensor          # [P, S] precomputed outgoing radiance
    n: torch.Tensor           # [P, 3] surface normals
    cell_start: torch.Tensor  # [C + 1]
    grid_lo: torch.Tensor
    inv_cell: torch.Tensor
    dims: Tuple[int, int, int]
    count: int


def build_radiance_map(pos, lo_rad, n, cell_size: float,
                       device=None) -> Optional[RadianceMap]:
    """The radiance photons' map, on `device` as in build_photon_map."""
    base = build_photon_map(pos, lo_rad, n, cell_size, device=device)
    if base is None:
        return None
    return RadianceMap(pos=base.pos, lo=base.alpha, n=base.wi, cell_start=base.cell_start,
                       grid_lo=base.grid_lo, inv_cell=base.inv_cell, dims=base.dims,
                       count=base.count)


RADIANCE_CAP = 16   # candidates a cell for the nearest radiance photon


def radiance_lookup(rm: Optional[RadianceMap], q, n, mask=None):
    """The nearest radiance photon with dot(rp.n, n) > 0 among the 27
    cells (the hemisphere test comes before the choice of the nearest;
    ties to the earlier candidate). -> (Lo [Q, S], found [Q])."""
    Q = q.shape[0]
    dev = q.device
    lo = torch.zeros((Q, S), device=dev)
    found = torch.zeros((Q,), dtype=torch.bool, device=dev)
    if rm is None or Q == 0:
        return lo, found
    live = live_queries(rm, q, mask)
    block = query_block(1, RADIANCE_CAP, dev)
    inf = torch.full((), float("inf"), device=dev)
    for s in range(0, live.shape[0], block):
        ids = live[s:s + block]
        qb, nb = q[ids], n[ids]
        idx, ok = _gather_candidates(rm, qb, RADIANCE_CAP)
        d2 = _sq_dist(rm.pos[idx], qb)
        nc = rm.n[idx]
        front = (nc[..., 0] * nb[:, 0:1] + nc[..., 1] * nb[:, 1:2] + nc[..., 2] * nb[:, 2:3]) > 0.0
        d2 = torch.where(ok & front, d2, inf)
        best = torch.argmin(d2, 1)
        fb = torch.isfinite(torch.gather(d2, 1, best[:, None])[:, 0])
        sel = torch.gather(idx, 1, best[:, None])[:, 0]
        lo[ids] = torch.where(fb[:, None], rm.lo[sel], torch.zeros((), device=dev))
        found[ids] = fb
    return lo, found
