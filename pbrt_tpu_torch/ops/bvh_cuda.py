"""Packet BVH t-pass: torch culling (Phase A) + the K2 leaf sweep (Phase B).

Port of pbrt_tpu/ops/bvh_pallas.py.

  Phase A (plain torch): rays are sorted by a coherence key and grouped
  into TILE-ray packets. Candidate leaf blocks per tile come from a
  tile-frustum interval test (coherent beams) or from an exact per-ray
  slab test reduced to entry-sorted per-tile lists (incoherent rays).
  The lists are compacted into a flat tile-grouped pair list.

  Phase B (kernel K2, csrc/bvh_sweep.cu): each tile's run of (tile,
  leaf block) pairs is cut into items (128-ray slice x SWEEP_CHUNK
  pairs) that a persistent grid sweeps in any order; each ray's
  candidates merge through the order-preserving keys of `pack_keys`,
  and `merge_keys` applies the winner: the same result as folding the
  run in list order (`wide_sweep_plain`).

  Waves: A fills lists -> B sweeps -> the per-tile t bound tightens ->
  A resumes. The wave loop is a Python loop with one host sync per
  wave (the done test). With tracing on (core/probes.py) a traversal is
  an `accel/traverse` span holding `accel/phase_a`, `accel/k2` and
  `sync/k2_done` spans.

`wide_sweep` dispatches on the device: CUDA tensors launch K2 (or
raise), CPU tensors run `wide_sweep_plain`, the same fold in torch.
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch.accel.wide_bvh import LEAF_W, MAX_L, TILE, WideBVH
from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.ops.build import check_cuda, load_kernels, raise_on_launch_error
from pbrt_tpu_torch.ops.intersect_cuda import KEY_EMPTY, key_of_t, t_of_key

BIG = 1e30
CHUNK = 1 << 20      # rays per traversal (bounds the Phase A tables)
MAX_WAVES = 64
CULL_BYTES = 512 << 20  # per [rays, blocks] temporary of the per-ray cull
PLAIN_TILES = 64        # tiles per step of the plain sweep (bounds its temporaries)

SWEEP_CHUNK = 2         # pairs per K2 work item (csrc/bvh_sweep.cu K2_CHUNK)
MAX_RUN = 1 << 24       # pair positions a key can hold

launches = 0  # K2 kernel launches in this process


# ---------------------------------------------------------------------------
# Phase B: the pair sweep

def _pair_steps(pair_block, tile_start, tile_count, sentinel_block: int):
    """(j, tiles, blocks) for each position j of the tiles' runs: the
    tiles whose run has a real (non-sentinel) block at j, in batches of
    at most PLAIN_TILES."""
    T = tile_start.shape[0]
    max_n = int(tile_count.max()) if T else 0
    for j in range(max_n):
        tiles = torch.nonzero(tile_count > j)[:, 0]
        blocks = pair_block[tile_start[tiles].long() + j].long()
        keep = blocks != sentinel_block
        tiles, blocks = tiles[keep], blocks[keep]
        for s in range(0, tiles.shape[0], PLAIN_TILES):
            yield j, tiles[s:s + PLAIN_TILES], blocks[s:s + PLAIN_TILES]


def _live_lanes(rays8):
    """Each tile's lanes with its live ones (tmin < tmax) first, cut to
    the most live lanes any tile has: [T, W] int64. A dead lane can hit
    nothing, so only these lanes need testing."""
    live = (rays8[:, 6] < rays8[:, 7]).view(-1, TILE)
    order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
    return order[:, :int(live.sum(1).max()) if live.shape[0] else 0]


def _block_min(rays8, tris16, tiles, blocks, lanes):
    """Per ray of each tile, the minimum t over its leaf block (BIG when
    nothing is hit) and its slot, lowest slot on ties: ([n, TILE] f32,
    [n, TILE] i64). Only the lanes `lanes` (_live_lanes) are tested; the
    others get (BIG, 0), as a dead lane's test gives."""
    from pbrt_tpu_torch.accel.intersect import mt_t

    dev = rays8.device
    n = tiles.shape[0]
    ln = lanes[tiles]                                            # [n, W]
    ry = torch.gather(rays8.view(-1, TILE, 8)[tiles], 1,
                      ln[..., None].expand(-1, -1, 8))           # [n, W, 8]
    cols = blocks[:, None] * LEAF_W + torch.arange(LEAF_W, device=dev)[None, :]
    tri = [tris16[c][cols][:, None, :] for c in range(9)]
    t, valid = mt_t(*tri, *(ry[:, :, i:i + 1] for i in range(8)))
    t_w, idx_w = torch.min(torch.where(valid, t, torch.full((), BIG, device=dev)), -1)
    t_blk = torch.full((n, TILE), BIG, device=dev).scatter_(1, ln, t_w)
    idx = torch.zeros((n, TILE), dtype=torch.int64, device=dev).scatter_(1, ln, idx_w)
    return t_blk, idx


def wide_sweep_plain(pair_block, tile_start, tile_count, rays8, tris16,
                     sentinel_block: int, t_acc, p_acc):
    """Plain torch twin of K2; updates t_acc/p_acc [T*TILE] in place.
    Pair j of every tile is swept in step j, so each tile's pairs fold
    in list order: a block minimum replaces the accumulator only when
    strictly smaller."""
    T = tile_start.shape[0]
    t_view = t_acc.view(T, TILE)
    p_view = p_acc.view(T, TILE)
    lanes = _live_lanes(rays8)
    for _, tt, bb in _pair_steps(pair_block, tile_start, tile_count, sentinel_block):
        t_blk, idx = _block_min(rays8, tris16, tt, bb, lanes)
        acc_t, acc_p = t_view[tt], p_view[tt]
        better = t_blk < acc_t
        t_view[tt] = torch.where(better, t_blk, acc_t)
        p_view[tt] = torch.where(better, (bb[:, None] * LEAF_W + idx).to(torch.int32), acc_p)
    return t_acc, p_acc


def pack_keys(t, pos, slot):
    """K2's merge keys (int64) of candidates (t f32, position in the
    tile's run, slot): key_of_t, then pos, then slot. The least key of a
    ray is its first minimum in list order, the candidate the sequential
    strict '<' fold keeps."""
    return key_of_t(t) | (pos.to(torch.int64) << 8) | (slot.to(torch.int64) << 1)


def unpack_keys(keys):
    """keys -> (t f32, pos i64, slot i64); the inverse of pack_keys."""
    lo = keys & 0xFFFFFFFF
    return t_of_key(keys), lo >> 8, (lo >> 1) & (LEAF_W - 1)


def merge_keys(keys, pair_block, tile_start, t_acc, p_acc):
    """The merge rule of K2 (csrc/bvh_sweep.cu k2_merge_kernel), in
    place: each ray's least key names its winning candidate, which
    replaces the accumulator when its t is strictly smaller."""
    t, pos, slot = unpack_keys(keys)
    tile = torch.arange(keys.shape[0], device=keys.device) // TILE
    better = (keys != KEY_EMPTY) & (t < t_acc)
    at = torch.where(better, tile_start.long()[tile] + pos, 0)
    prim = (pair_block.long()[at] * LEAF_W + slot).to(torch.int32)
    t_acc.copy_(torch.where(better, t, t_acc))
    p_acc.copy_(torch.where(better, prim, p_acc))
    return t_acc, p_acc


def wide_sweep_chunked(pair_block, tile_start, tile_count, rays8, tris16,
                       sentinel_block: int, t_acc, p_acc, chunk: int, order):
    """Plain torch model of K2's decomposition; updates t_acc/p_acc in
    place. Every tile's run is cut into chunks of `chunk` pairs; each
    chunk yields one key per ray (the least of its candidates' keys), the
    chunks merge by key minimum in `order` (a permutation of the chunk
    indices), and merge_keys applies the result.
    Equals wide_sweep_plain bit for bit whatever the chunk and order."""
    T = tile_start.shape[0]
    keys = torch.full((T, TILE), KEY_EMPTY, dtype=torch.int64, device=rays8.device)
    parts: dict = {}
    lanes = _live_lanes(rays8)
    for j, tt, bb in _pair_steps(pair_block, tile_start, tile_count, sentinel_block):
        t_blk, idx = _block_min(rays8, tris16, tt, bb, lanes)
        if j // chunk not in parts:
            parts[j // chunk] = torch.full_like(keys, KEY_EMPTY)
        part = parts[j // chunk]
        part[tt] = torch.minimum(part[tt], pack_keys(t_blk, torch.full_like(idx, j), idx))
    for c in order:
        if c in parts:
            keys = torch.minimum(keys, parts[c])
    return merge_keys(keys.view(-1), pair_block, tile_start, t_acc, p_acc)


def wide_sweep_cuda(pair_block, tile_start, tile_count, rays8, tris16,
                    sentinel_block: int, t_acc, p_acc):
    """Launch K2 on the current stream; updates t_acc/p_acc in place."""
    global launches
    T = tile_start.shape[0]
    check_cuda(pair_block, "pair_block", torch.int32)
    check_cuda(tile_start, "tile_start", torch.int32, (T,))
    check_cuda(tile_count, "tile_count", torch.int32, (T,))
    check_cuda(rays8, "rays8", torch.float32, (T * TILE, 8))
    check_cuda(tris16, "tris16", torch.float32)
    check_cuda(t_acc, "t_acc", torch.float32, (T * TILE,))
    check_cuda(p_acc, "p_acc", torch.int32, (T * TILE,))
    if tris16.shape[0] != 16 or tris16.shape[1] % LEAF_W:
        raise ValueError(f"tris16: expected [16, k*{LEAF_W}], got {tuple(tris16.shape)}")
    if sentinel_block != tris16.shape[1] // LEAF_W - 1:
        raise ValueError("sentinel_block must be the last block of tris16")
    if pair_block.numel() >= MAX_RUN:
        raise ValueError(f"pair_block: at most {MAX_RUN - 1} pairs")
    if rays8.data_ptr() % 16 or tris16.data_ptr() % 16:
        raise ValueError("rays8 and tris16 must be 16-byte aligned")
    lib = load_kernels()
    # freed on return: the caching allocator reuses it only after the
    # work queued on this stream, K2 included
    scratch = torch.empty((lib.pbrt_wide_sweep_scratch_bytes(T),), dtype=torch.uint8,
                          device=rays8.device)
    stream = torch.cuda.current_stream(rays8.device).cuda_stream
    err = lib.pbrt_wide_sweep(pair_block.data_ptr(), tile_start.data_ptr(),
                              tile_count.data_ptr(), T, rays8.data_ptr(),
                              tris16.data_ptr(), tris16.shape[1], sentinel_block,
                              t_acc.data_ptr(), p_acc.data_ptr(), scratch.data_ptr(), stream)
    raise_on_launch_error(err, "wide_sweep_kernel")
    launches += 1
    return t_acc, p_acc


def wide_sweep(pair_block, tile_start, tile_count, rays8, tris16,
               sentinel_block: int, t_acc, p_acc):
    """Kernel for CUDA tensors, plain twin for CPU tensors."""
    fn = wide_sweep_plain if rays8.device.type == "cpu" else wide_sweep_cuda
    return fn(pair_block, tile_start, tile_count, rays8, tris16, sentinel_block,
              t_acc, p_acc)


# ---------------------------------------------------------------------------
# Phase A: culling

def _safe_inv(d):
    tiny = torch.where(d < 0, torch.full((), -1e-20, device=d.device),
                       torch.full((), 1e-20, device=d.device))
    return 1.0 / torch.where(torch.abs(d) > 1e-20, d, tiny)


def _frusta(o, d, tmin, tmax, live, T):
    """Per-tile conservative interval bounds:
    (olo, ohi, ilo, ihi [T,3]; tmin_t, tmax_t [T]; alive [T] bool)."""
    o3 = o.reshape(T, TILE, 3)
    lv = live.reshape(T, TILE, 1)
    inv = _safe_inv(d.reshape(T, TILE, 3))
    olo = torch.amin(torch.where(lv, o3, BIG), 1)
    ohi = torch.amax(torch.where(lv, o3, -BIG), 1)
    ilo = torch.amin(torch.where(lv, inv, BIG), 1)
    ihi = torch.amax(torch.where(lv, inv, -BIG), 1)
    lvf = lv[:, :, 0]
    tmin_tile = torch.amin(torch.where(lvf, tmin.reshape(T, TILE), BIG), 1)
    tmax_c = torch.where(torch.isfinite(tmax), tmax, BIG).reshape(T, TILE)
    tmax_tile = torch.amax(torch.where(lvf, tmax_c, -BIG), 1)
    alive = torch.any(lvf, 1)
    return olo, ohi, ilo, ihi, tmin_tile, tmax_tile, alive


def _dense_cull(wb: WideBVH, frus, tmax_t, swept):
    """Select up to MAX_L NEAREST (by conservative entry t) unswept
    candidate blocks per tile. Returns (lst [T, MAX_L] with sentinel
    padding, nl [T], swept', done [T])."""
    olo, ohi, ilo, ihi, tmin_t, _, alive = frus
    T = olo.shape[0]
    B = wb.block_lo.shape[0]
    blo = wb.block_lo[None, :, :]      # [1, B, 3]
    bhi = wb.block_hi[None, :, :]
    u1 = blo - ohi[:, None, :]         # [T, B, 3]
    u2 = blo - olo[:, None, :]
    v1 = bhi - ohi[:, None, :]
    v2 = bhi - olo[:, None, :]
    il = ilo[:, None, :]
    ih = ihi[:, None, :]
    p = (u1 * il, u1 * ih, u2 * il, u2 * ih, v1 * il, v1 * ih, v2 * il, v2 * ih)
    e_min = p[0]
    x_max = p[0]
    for q in p[1:]:
        e_min = torch.minimum(e_min, q)
        x_max = torch.maximum(x_max, q)
    L = torch.maximum(torch.amax(e_min, -1), tmin_t[:, None])   # [T, B]
    U = torch.amin(x_max, -1)
    sel = ((L <= U * 1.0001) & (L <= tmax_t[:, None]) & alive[:, None] & ~swept)
    count = torch.sum(sel, 1)
    # nearest-first: the k largest -entry_t; a stable descending sort
    # puts the lower block index first on ties, as lax.top_k does
    score = torch.where(sel, -L, float("-inf"))
    k = min(MAX_L, B)
    val, idx = torch.sort(score, dim=1, descending=True, stable=True)
    val, idx = val[:, :k], idx[:, :k]
    got = val > float("-inf")
    lst = torch.where(got, idx, wb.n_blocks)
    if k < MAX_L:
        pad = torch.full((T, MAX_L - k), wb.n_blocks, dtype=lst.dtype, device=lst.device)
        lst = torch.cat([lst, pad], -1)
        got = torch.cat([got, torch.zeros((T, MAX_L - k), dtype=torch.bool,
                                          device=got.device)], -1)
    newly = torch.zeros((T, B), dtype=torch.int32, device=swept.device).scatter_reduce(
        1, torch.clamp(lst, 0, B - 1), got.to(torch.int32), reduce="amax")
    swept = swept | (newly > 0)
    nl = torch.clamp(count, max=MAX_L)
    done = count <= MAX_L
    return lst, nl, swept, done


def _perray_candidates(wb: WideBVH, o_s, inv_s, tmin_s, t_cap, live):
    """Exact per-ray slab culling into per-tile entry-sorted candidate
    lists, computed once per traversal. Returns (cand_L [T, B] ascending
    entry t per tile (inf pad), cand_b [T, B] block ids in that order,
    count [T] real candidates).

    The [rays, blocks] temporaries are bounded by CULL_BYTES through the
    number of tiles per chunk; dead tiles (a sorted suffix) are skipped."""
    R = o_s.shape[0]
    T = R // TILE
    B = wb.block_lo.shape[0]
    dev = o_s.device
    TC = max(1, min(64, CULL_BYTES // (TILE * B * 4)))
    live_tiles = torch.any(live.reshape(T, TILE), -1)
    n_live = 0
    with probes.scope("sync/n_live"):
        any_live = bool(live_tiles.any())
    if any_live:
        with probes.scope("sync/n_live"):
            live_ids = torch.nonzero(live_tiles)
        with probes.scope("sync/n_live"):
            n_live = int(live_ids[-1, 0]) + 1
    Lt = torch.full((T, B), float("inf"), device=dev)
    for s in range(0, n_live, TC):
        e = min(s + TC, n_live)
        rs, re_ = s * TILE, e * TILE
        oc, ic = o_s[rs:re_], inv_s[rs:re_]
        L = tmin_s[rs:re_, None].expand(-1, B)
        U = None
        for a in range(3):
            t1 = (wb.block_lo[None, :, a] - oc[:, None, a]) * ic[:, None, a]
            t2 = (wb.block_hi[None, :, a] - oc[:, None, a]) * ic[:, None, a]
            L = torch.maximum(L, torch.minimum(t1, t2))
            hi = torch.maximum(t1, t2)
            U = hi if U is None else torch.minimum(U, hi)
        ok = (L <= U * 1.0001) & (L <= t_cap[rs:re_, None]) & live[rs:re_, None]
        Lm = torch.where(ok, L, float("inf"))
        Lt[s:e] = torch.amin(Lm.reshape(e - s, TILE, B), 1)
    cand_L, cand_b = torch.sort(Lt, dim=1, stable=True)
    count = torch.sum(torch.isfinite(Lt), 1)
    return cand_L, cand_b, count


def _window_cull(cand_L, cand_b, count, ptr, tile_t, sentinel_block):
    """Consume the next <= MAX_L candidates per tile whose entry t is
    within the tile's current bound (an ascending prefix). Returns
    (lst [T, MAX_L], nl [T], ptr', done [T])."""
    T, B = cand_L.shape
    win = ptr[:, None] + torch.arange(MAX_L, device=ptr.device)[None, :]
    win_c = torch.clamp(win, 0, B - 1)
    wl = torch.gather(cand_L, 1, win_c)
    wb_ = torch.gather(cand_b, 1, win_c)
    ok = (win < count[:, None]) & (wl <= tile_t[:, None] * 1.0001)
    lst = torch.where(ok, wb_, sentinel_block)
    nl = torch.sum(ok, 1)
    ptr2 = ptr + nl
    done = (ptr2 >= count) | (nl == 0)
    return lst, nl, ptr2, done


def _morton3(q, bits):
    m = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for b in range(bits):
        m = (m
             | (((q[:, 0] >> b) & 1) << (3 * b))
             | (((q[:, 1] >> b) & 1) << (3 * b + 1))
             | (((q[:, 2] >> b) & 1) << (3 * b + 2)))
    return m


def _coherence_sort(o, d, world_lo, world_hi):
    """Sort key: origin Morton (high), direction octant+Morton (low)."""
    on = torch.clamp((o - world_lo) / torch.clamp(world_hi - world_lo, min=1e-12), 0.0, 1.0)
    mo = _morton3((on * 31.0).to(torch.int64), 5)          # 15 bits
    oct_ = ((d[:, 0] < 0).to(torch.int64)
            | ((d[:, 1] < 0).to(torch.int64) << 1)
            | ((d[:, 2] < 0).to(torch.int64) << 2))
    qd = (torch.clamp(d * 0.5 + 0.5, 0.0, 1.0) * 15.0).to(torch.int64)
    md = _morton3(qd, 4)                                    # 12 bits
    return (mo << 15) | (oct_ << 12) | md


def _sort_rays(o, d, tmin, tmax, world_lo, world_hi):
    """Stable coherence sort; dead rays (tmax <= tmin) sort to the end.
    Returns sorted columns + the permutation (for the unsort)."""
    key = _coherence_sort(o, d, world_lo, world_hi)
    key = torch.where(tmax > tmin, key, 0xFFFFFFFF)
    perm = torch.sort(key, stable=True).indices
    return o[perm], d[perm], tmin[perm], tmax[perm], perm


def _compact_pairs(lst, nl):
    """[T, MAX_L] lists -> flat tile-grouped pair list. Returns
    (pair_block [T*MAX_L] int32, tile_start [T] int32, tile_count [T]
    int32); tile t's pairs are pair_block[start : start + count]."""
    T = lst.shape[0]
    dev = lst.device
    start = torch.cumsum(nl, 0) - nl                       # exclusive cumsum
    slot = torch.arange(MAX_L, device=dev)[None, :]
    mask = slot < nl[:, None]
    dump = T * MAX_L
    pos = torch.where(mask, start[:, None] + slot, dump)
    pair_block = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    pair_block.scatter_(0, pos.reshape(-1), lst.reshape(-1).to(torch.int32))
    return (pair_block[:dump].contiguous(), start.to(torch.int32).contiguous(),
            nl.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# Driver

def _wide_t_pass_chunk(wb: WideBVH, o, d, tmin, tmax, any_hit=False, coherent=False):
    R = o.shape[0]
    T = R // TILE
    with probes.scope("accel/phase_a"):
        o_s, d_s, tmin_s, tmax_s, idx_s = _sort_rays(o, d, tmin, tmax, wb.world_lo,
                                                     wb.world_hi)
        live_s = tmax_s > tmin_s
        tmax_c = torch.where(torch.isfinite(tmax_s), tmax_s, BIG)
        rays8 = torch.cat([o_s, d_s, tmin_s[:, None], tmax_c[:, None]], -1).contiguous()

        # cap the pruning bound at the world-bbox exit: no hit can lie
        # beyond it, and it keeps miss rays from pinning their tile's
        # bound at inf
        inv_s = _safe_inv(d_s)
        t_a = (wb.world_lo[None, :] - o_s) * inv_s
        t_b = (wb.world_hi[None, :] - o_s) * inv_s
        exit_t = torch.amin(torch.maximum(t_a, t_b), -1) * 1.001 + 1e-4
        cap = torch.minimum(tmax_c, torch.clamp(exit_t, min=0.0))
        t_acc = torch.where(live_s, cap, -BIG).contiguous()
        p_acc = torch.full((R,), -1, dtype=torch.int32, device=o.device)
        if coherent:
            frus = _frusta(o_s, d_s, tmin_s, tmax_s, live_s, T)
            swept = torch.zeros((T, wb.block_lo.shape[0]), dtype=torch.bool, device=o.device)
        else:
            cand_L, cand_b, count = _perray_candidates(wb, o_s, inv_s, tmin_s, cap, live_s)
            ptr = torch.zeros((T,), dtype=torch.int64, device=o.device)

    def tile_bound():
        # per-tile farthest useful t; any-hit (shadow) queries retire a
        # lane at its first hit (reference bvh.cpp:639-687 IntersectP)
        cap_lane = t_acc.reshape(T, TILE)
        if any_hit:
            hit_lane = (p_acc >= 0).reshape(T, TILE)
            return torch.amax(torch.where(hit_lane, -BIG, cap_lane), 1)
        return torch.amax(cap_lane, 1)

    # waves: Phase A fills each tile's list, K2 sweeps it, and the host
    # reads whether every tile's list is exhausted
    for _ in range(MAX_WAVES):
        with probes.scope("accel/phase_a"):
            if coherent:
                lst, nl, swept, done = _dense_cull(wb, frus, tile_bound(), swept)
            else:
                lst, nl, ptr, done = _window_cull(cand_L, cand_b, count, ptr, tile_bound(),
                                                  wb.n_blocks)
            pair_block, start, n_pairs = _compact_pairs(lst, nl)
        with probes.scope("accel/k2"):
            wide_sweep(pair_block, start, n_pairs, rays8, wb.tris16, wb.n_blocks, t_acc, p_acc)
        with probes.scope("sync/k2_done"):
            finished = bool(done.all())
        if finished:
            break

    # padded slot -> global prim id; then undo the coherence sort
    prim = p_acc.long()
    gprim = torch.where(prim >= 0, wb.prim_map[torch.clamp(prim, min=0)], -1)
    miss = (gprim < 0) | (t_acc >= BIG) | ~live_s
    t_out = torch.empty_like(t_acc)
    p_out = torch.empty_like(gprim)
    t_out[idx_s] = torch.where(miss, BIG, t_acc)
    p_out[idx_s] = torch.where(miss, -1, gprim)
    return t_out, p_out


@probes.spanned("accel/traverse")
def wide_t_pass(wb: WideBVH, ray_o, ray_d, tmin, tmax, any_hit=False, coherent=False):
    """[R] rays -> (t [R], global prim [R] int64, -1 = miss). Pads to
    TILE multiples and traverses in chunks of CHUNK rays. any_hit:
    occlusion semantics (the returned t is then SOME hit, not the
    nearest). coherent: the batch is beam-like (camera/shadow rays) —
    selects the tile-frustum cull instead of the per-ray slab cull."""
    R = ray_o.shape[0]
    Rpad = max(TILE, (R + TILE - 1) // TILE * TILE)
    if Rpad != R:
        pad = Rpad - R
        dev = ray_o.device
        ray_o = torch.cat([ray_o, torch.zeros((pad, 3), device=dev)])
        ray_d = torch.cat([ray_d, torch.ones((pad, 3), device=dev)])
        tmin = torch.cat([tmin, torch.zeros((pad,), device=dev)])
        tmax = torch.cat([tmax, torch.full((pad,), -1.0, device=dev)])
    outs_t, outs_p = [], []
    for s in range(0, Rpad, CHUNK):
        e = min(s + CHUNK, Rpad)
        t, p = _wide_t_pass_chunk(wb, ray_o[s:e], ray_d[s:e], tmin[s:e], tmax[s:e],
                                  any_hit=any_hit, coherent=coherent)
        outs_t.append(t)
        outs_p.append(p)
    t = torch.cat(outs_t) if len(outs_t) > 1 else outs_t[0]
    p = torch.cat(outs_p) if len(outs_p) > 1 else outs_p[0]
    return t[:R], p[:R]
