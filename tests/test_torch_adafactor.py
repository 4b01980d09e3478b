"""Adafactor's update of one layer group (``repro_torch.kernels.adafactor``)
on the CPU.

* ``adafactor_update_plain`` against the reference's Adafactor
  (``repro.training.optimizer.adafactor``): the same numpy inputs, float32,
  2e-6 (the two frameworks' means sum in other orders).  A factored 2-D
  leaf, a stacked group of 2-D layers, a stacked group of 1-D layers (an
  (L, D) matrix for the reference), 1-D, 0-d, a last dim of 1 alone and
  stacked; the clip active and inactive, zero gradients; after step 1
  (beta2 = 0) and step 3.
* The wrapper on CPU tensors is the plain version and launches nothing.
* A float32 emulation of the kernels' summation plan (``launch_plan`` at
  the card's 132 SMs: slabs, chunks, per-thread chains and trees, in the
  order ``csrc/adafactor.cu`` takes them), held against the plain version
  within the card's tolerances: vr, vc and v 1e-5 relative, a float32
  parameter's change 1e-5 relative L2, a bf16 parameter within one bf16
  ulp.  A skinny leaf of 100,000 rows shows that the plan keeps its long
  column sums within 1e-5 of their exact (float64) values.
* ``adafactor(..., plain_kernels=True)`` is the same optimizer on the CPU.
"""
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as JO
from repro_torch import kernels as K
from repro_torch.configs import get_tiny_config
from repro_torch.configs import get_config
from repro_torch.kernels import adafactor as AF
from repro_torch.models.params import abstract_params
from repro_torch.training import optimizer as TO

TOL = 2e-6          # plain against the reference (float32)
STATE_TOL = 1e-5    # the kernels' plan against the plain version: vr, vc, v
UPDATE_TOL = 1e-5   # and a float32 parameter's change (relative L2)
LR, WD = 1e-2, 0.1
EPS1, EPS2, CLIP = 1e-30, 1e-3, 1.0
SMS = 132           # the H100's SMs: the plan the card runs
HP = dict(eps1=EPS1, eps2=EPS2, clip_threshold=CLIP, weight_decay=WD)

# (name, layers or None for one unstacked tensor, a layer's shape)
GROUPS = [
    ("matrix", None, (24, 40)),
    ("stacked_matrices", 3, (16, 24)),
    ("stacked_vectors", 4, (32,)),
    ("vector", None, (37,)),
    ("scalar", None, ()),
    ("last_dim_1", None, (12, 1)),
    ("stacked_last_dim_1", 3, (5, 1, 7)),
    ("guard_fails", None, (24, 40)),
]
# the gradient's scale at each of three steps: step 3's large gradient
# against the moments of steps 1-2 makes the update's RMS exceed the
# threshold; a small one keeps it under
REGIMES = {"clip": (1.0, 1.0, 100.0), "no_clip": (1.0, 1.0, 0.01), "zero": (0.0, 0.0, 0.0)}


def arrays(rng, layers, shape, scales, name=""):
    """p and a gradient a step.  A ``guard`` group's gradients have, over
    the last two dims, a quarter of the rows 0, a quarter tiny (1e-18: their
    vr stays near eps1) and the rest normal, half the columns scaled by 0.1:
    a tiny row's denominator in such a column falls under eps1, so a clamp
    bites on a nonzero g and the factorised sum of u^2 cannot stand."""
    full = shape if layers is None else (layers, *shape)
    p = rng.standard_normal(full).astype(np.float32) * np.float32(0.5)
    gs = [(rng.standard_normal(full) * s).astype(np.float32) for s in scales]
    if name.startswith("guard"):
        R, C = full[-2:]
        rows = np.ones(R, np.float32)
        rows[: R // 4] = 0.0
        rows[R // 4: R // 2] = 1e-18
        cols = np.where(np.arange(C) % 2 == 0, 1.0, 0.1).astype(np.float32)
        gs = [g * rows[:, None] * cols for g in gs]
    return p, gs


def as_group(a, layers):
    """A port group from the reference's array: its layers (views copied) or the tensor."""
    if layers is None:
        return [torch.from_numpy(np.array(a))]
    return [torch.from_numpy(np.array(a[i])) for i in range(layers)]


def port_state(full):
    if AF.factored(full):
        return {"vr": torch.zeros(full[:-1]), "vc": torch.zeros((*full[:-2], full[-1]))}
    return {"v": torch.zeros(full)}


def scalars(step: int):
    s = torch.tensor(step, dtype=torch.int32)
    return {"lr": TO.cosine_schedule(LR, warmup=1)(s), "beta2": 1.0 - s.to(torch.float32) ** -0.8}


def rms_of_update(g, state) -> float:
    """sqrt(mean(u^2) + eps1) in float64 from a step's gradient and new state."""
    g = g.astype(np.float64)
    if "vr" in state:
        vr, vc = (np.asarray(state[k], np.float64) for k in ("vr", "vc"))
        d = (vr / np.maximum(vr.mean(-1, keepdims=True), EPS1))[..., None] * vc[..., None, :]
    else:
        d = np.asarray(state["v"], np.float64)
    u = g / np.sqrt(np.maximum(d, EPS1))
    return float(np.sqrt(np.mean(u * u) + EPS1))


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("name,layers,shape", GROUPS)
def test_plain_update_matches_the_reference(name, layers, shape, regime):
    rng = np.random.default_rng(zlib.crc32(f"{name}/{regime}".encode()))
    p, gs = arrays(rng, layers, shape, REGIMES[regime], name)
    full = p.shape
    jopt = JO.adafactor(JO.cosine_schedule(LR, warmup=1), weight_decay=WD)
    jp = {"w": jnp.asarray(p)}
    jst = jopt.init(jp)
    tp = as_group(p, layers)
    ts = port_state(full)
    for step, g in enumerate(gs, 1):
        jp, jst = jopt.update({"w": jnp.asarray(g)}, jst, jp)
        AF.adafactor_update_plain(as_group(g, layers), tp, ts, **scalars(step), **HP)
        if step in (1, 3):
            got = np.stack([t.numpy() for t in tp]) if layers else tp[0].numpy()
            np.testing.assert_allclose(got, np.asarray(jp["w"]), rtol=TOL, atol=TOL)
            for k, v in jst["f"][0].items():
                np.testing.assert_allclose(ts[k].numpy(), np.asarray(v), rtol=TOL, atol=0)
    rms = rms_of_update(gs[-1], {k: np.asarray(v) for k, v in jst["f"][0].items()})
    assert (rms > CLIP) == (regime == "clip"), rms


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    p, gs = arrays(rng, 3, (16, 24), (1.0,))
    mine, want = as_group(p, 3), as_group(p, 3)
    s_mine, s_want = port_state(p.shape), port_state(p.shape)
    K.reset_launch_counts()
    K.adafactor_update(as_group(gs[0], 3), mine, s_mine, **scalars(1), **HP)
    K.adafactor_update_plain(as_group(gs[0], 3), want, s_want, **scalars(1), **HP)
    assert all(torch.equal(a, b) for a, b in zip(mine, want))
    assert all(torch.equal(s_mine[k], s_want[k]) for k in s_want)
    assert K.launch_counts()["adafactor"] == 0


def test_wrapper_raises_where_it_has_no_kernel():
    t = torch.zeros(8, 8, device="meta")
    s = torch.zeros((), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        K.adafactor_update([t], [t], {"vr": torch.zeros(8, device="meta"),
                                      "vc": torch.zeros(8, device="meta")},
                           lr=s, beta2=s, **HP)


def test_a_state_that_does_not_fit_the_group_raises():
    with pytest.raises(ValueError, match="does not fit"):
        AF.group_shape([torch.zeros(4, 6)] * 2, {"vr": torch.zeros(3, 4), "vc": torch.zeros(3, 6)})


# ---------------------------------------------------------------------------
# the kernels' summation plan, emulated in float32
# ---------------------------------------------------------------------------

F = np.float32


def tree(x, axis=0):
    """Adjacent pairs, level by level, along ``axis`` (the kernels' tree)."""
    x = np.moveaxis(np.asarray(x, F), axis, 0).copy()
    w = 1
    while w < x.shape[0]:
        i = np.arange(0, x.shape[0] - w, 2 * w)
        x[i] = x[i] + x[i + w]
        w *= 2
    return x[0]


def chain(x, axis=0, start=0.0):
    """A sequential float32 sum along ``axis``, from ``start``."""
    x = np.moveaxis(np.asarray(x, F), axis, 0)
    acc = np.full(x.shape[1:], start, F)
    for t in x:
        acc = acc + t
    return acc


def rsqrt(d):
    return F(1) / np.sqrt(d)


def strided(part, k, pad=0.0):
    """``part`` zero-padded to rows of ``k``: row i holds part[i k .. i k + k)."""
    part = np.asarray(part, F)
    n = max(1, -(-len(part) // k))
    out = np.full(n * k, pad, F)
    out[:len(part)] = part
    return out.reshape(n, k)


def tail_scalars(upart, ppart, N, lr, threads=AF.THREADS):
    """finish_scalars in a block of ``threads``: thread t adds every
    threads-th partial from t in a chain, a tree over the block; then the
    clip divisor, lr x scale, lr x wd."""
    us, ps = (tree(chain(strided(part, threads), 0)) for part in (upart, ppart))
    N = F(N)
    rms = np.sqrt(us / N + F(EPS1))
    d = max(rms / F(CLIP), F(1))
    scale = max(np.sqrt(ps / N), F(EPS2))
    return d, F(lr) * scale, F(lr) * F(WD)


def slab_walk(a, SR, S, vec):
    """(M, R, C) -> (M, S, steps, 8 warps, chunks, 32 lanes, vec), zeros where
    no element: a slab of SR rows, warp w its rows w, w + 8, ..."""
    M, R, C = a.shape
    CW = 32 * vec
    Kc, steps = -(-C // CW), -(-SR // 8)
    out = np.zeros((M, S * SR, C), F)
    out[:, :R] = a
    pad = np.zeros((M, S, steps * 8, Kc * CW), F)
    pad[:, :, :SR, :C] = out.reshape(M, S, SR, C)
    return pad.reshape(M, S, steps, 8, Kc, 32, vec)


def thread_partials(v, vec):
    """Per slab: each thread's chain over (chunk, step) of its vector trees,
    then the warp's tree, then the block's.  ``v``: slab_walk's layout."""
    t = tree(v, -1)                                       # (M, S, steps, 8, K, 32)
    t = np.transpose(t, (0, 1, 3, 5, 4, 2))               # (M, S, 8, 32, K, steps)
    t = chain(t.reshape(*t.shape[:4], -1), -1)            # k outer, step inner
    return tree(tree(t, -1), -1).reshape(-1)              # lanes, then warps


def vec_chunks(a, vec):
    """(..., C) -> (..., chunks, 32, vec), zero-padded: lane l of chunk k
    holds columns k 32 vec + l vec .. + vec - 1."""
    C = a.shape[-1]
    CW = 32 * vec
    out = np.zeros((*a.shape[:-1], -(-C // CW) * CW), F)
    out[..., :C] = a
    return out.reshape(*a.shape[:-1], -1, 32, vec)


def guard_fails(W, v, mv, rm) -> bool:
    """A column that holds a nonzero g^2 (W without its sign bit) whose
    smallest denominator fl(fl(min vr / m) vc) falls under eps1."""
    return bool(np.any(~np.signbit(W) & ((F(mv) / F(rm)) * v < F(EPS1))))


def rows_slab(gs, ps, vr_old, b, plan):
    """af_rows_kernel over one slab (gs, ps: its rows x C): new vr, the slab's
    p^2 partial, vr's slab sum, the least vr of a row holding a nonzero g^2
    (inf if none), and the column sums of g^2 + eps1 and of W, each as its
    row groups hold them (RG x C)."""
    rows, C = gs.shape
    NT, NW = AF.ROWS_THREADS, AF.ROWS_THREADS // 32
    vec, TR, lanes = plan["vec"], plan["tile_rows"], plan["lanes"]
    WPR = plan["warps_a_row"]
    RG = NT // lanes
    eps1, omb = F(EPS1), F(1) - b
    tiles = -(-rows // TR)
    g2 = gs * gs
    # rows: each lane's chunks of its warp's share in a chain, the warp's
    # tree, a tree over the row's WPR warps
    vt = tree(vec_chunks(g2 + eps1, vec), -1)             # (rows, K, 32)
    K = vt.shape[1]
    segs = np.zeros((rows, 16), F)
    for s in range(WPR):
        segs[:, s] = tree(chain(vt[:, s::WPR, :], 1), -1)
    v = b * vr_old + omb * (tree(segs, -1) / F(C))
    nz = (g2 > 0).any(-1)
    vrc = np.zeros(NT, F)                                 # thread j: row j of each tile
    vrc[:TR] = chain(strided(v, TR), 0)
    mv = v[nz].min() if nz.any() else F(np.inf)
    # p^2: thread (w, l)'s chain over its rows' chunks, tile by tile
    pt = tree(vec_chunks(ps * ps, vec), -1)               # (rows, K, 32)
    pacc = np.zeros((NW, 32), F)
    for t in range(tiles):
        n = min(TR, rows - t * TR)
        for w in range(NW):
            js = range(w, n, NW) if WPR == 1 else [w // WPR] if w // WPR < n else []
            for j in js:
                for k in range(0 if WPR == 1 else w % WPR, K, WPR):
                    pacc[w] = pacc[w] + pt[t * TR + j, k]
    # columns: row group rg's rows rg, rg + RG, ... of each tile in a chain
    order = [[t * TR + j for t in range(tiles) for j in range(rg, min(TR, rows - t * TR), RG)]
             for rg in range(RG)]
    x2 = g2.reshape(rows, -1, vec)
    a, wq = x2 + eps1, x2 * (F(1) / v)[:, None, None]
    cs = np.zeros((RG, *x2.shape[1:]), F)
    ws = np.full((RG, *x2.shape[1:]), -0.0, F)
    for i in range(max(len(o) for o in order)):
        for rg, o in enumerate(order):
            if i < len(o):
                r = o[i]
                cs[rg] = cs[rg] + a[r]
                ws[rg] = np.where(x2[r] > 0, ws[rg] + wq[r], ws[rg])
    return (v, tree(pacc.reshape(-1)), tree(vrc), mv, tree(cs, 0).reshape(C),
            tree(ws, 0).reshape(C))


def term_order(C, vec, lanes):
    """The order in which af_rows_kernel's threads add a matrix's u^2 terms
    (one slab a matrix): {thread: [columns]}, as index lists.  One row group:
    thread t its column vectors t + kc LANES, element by element; more: thread
    t the elements ce = t, t + NT, ... (element ce / CV of column vector ce % CV)."""
    NT, cv = AF.ROWS_THREADS, C // vec
    if lanes == NT:
        return [[(t + kc * NT) * vec + e for kc in range(-(-cv // NT)) if t + kc * NT < cv
                 for e in range(vec)] for t in range(NT)]
    return [[(ce % cv) * vec + ce // cv for ce in range(t, C, NT)] for t in range(NT)]


def emulate_rows(g, p, vr, vc, plan, lr, b):
    """af_rows_kernel, af_usq_kernel where the guard fails, af_apply_kernel,
    in float32: g, p (M, R, C) widened, vr (M, R), vc (M, C); returns new p,
    vr, vc and whether the guard held."""
    M, R, C = g.shape
    NW = AF.ROWS_THREADS // 32
    vec, SR, S = plan["vec"], plan["slab_rows"], plan["slabs_a_matrix"]
    omb, eps1 = F(1) - b, F(EPS1)
    vr_new, vc_new, rmean = np.empty_like(vr), np.empty_like(vc), np.empty(M, F)
    ppart, upart, fails = np.zeros(M * S, F), [], []
    colpart, wpart = np.zeros((M, S, C), F), np.zeros((M, S, C), F)
    vrpart, minvr = np.zeros((M, S), F), np.zeros((M, S), F)
    order = term_order(C, vec, plan["lanes"])
    for m in range(M):
        for s in range(S):
            r0, r1 = s * SR, min(R, s * SR + SR)
            v, ps, vrs, mv, cs, W = rows_slab(g[m, r0:r1], p[m, r0:r1], vr[m, r0:r1], b, plan)
            vr_new[m, r0:r1], ppart[m * S + s] = v, ps
            if S > 1:
                colpart[m, s], wpart[m, s], vrpart[m, s], minvr[m, s] = cs, W, vrs, mv
                continue
            rm = max(vrs / F(R), eps1)
            vc_new[m] = b * vc[m] + omb * (cs / F(R))
            term = W / vc_new[m]
            T = tree(np.array([chain(term[o]) if o else F(0) for o in order], F))
            upart.append(rm * T)
            fails.append(guard_fails(W, vc_new[m], mv, rm))
            rmean[m] = rm
    if S > 1:   # the grid's column sums: 32 columns an item, warp w the slabs w, w + NW, ...
        for m in range(M):
            vs = tree(chain(strided(vrpart[m], 32), 0))   # lane l: slabs l, l + 32, ...
            rm, mv = max(vs / F(R), eps1), minvr[m].min()
            rmean[m] = rm
            for c0 in range(0, C, 32):
                cols = slice(c0, min(C, c0 + 32))
                cs = tree(chain(strided_rows(colpart[m, :, cols], NW, 0.0), 0), 0)
                W = tree(chain(strided_rows(wpart[m, :, cols], NW, -0.0), 0, -0.0), 0)
                v = b * vc[m, cols] + omb * (cs / F(R))
                vc_new[m, cols] = v
                term = np.zeros(32, F)
                term[:v.size] = W / v
                upart.append(rm * tree(term))
                fails.append(guard_fails(W, v, mv, rm))
    d = (vr_new / rmean[:, None])[:, :, None] * vc_new[:, None, :]
    u = rsqrt(np.maximum(d, eps1)) * g
    guard = not any(fails)
    if guard:
        dclip, ls, lwd = tail_scalars(upart, ppart, M * R * C, lr, AF.ROWS_THREADS)
    else:       # (b): the sums of u^2 on the update's own slabs
        SR2, S2 = plan["slab_rows2"], plan["slabs_a_matrix2"]
        upart = thread_partials(slab_walk(u * u, SR2, S2, vec), vec)
        dclip, ls, lwd = tail_scalars(upart, ppart, M * R * C, lr)
    new_p = (p - (u / dclip) * ls) - lwd * p
    return new_p, vr_new, vc_new, guard


def strided_rows(a, k, pad):
    """(S, n) -> (ceil(S / k), k, n) padded with ``pad``: row i holds S-rows i k .. i k + k."""
    S = a.shape[0]
    out = np.full((max(1, -(-S // k)) * k, *a.shape[1:]), pad, F)
    out[:S] = a
    return out.reshape(-1, k, *a.shape[1:])


def emulate_wide(g, p, vr, vc, plan, lr, b):
    """af_wide_kernel, af_usq_kernel, af_apply_kernel in float32 (rows wider
    than af_rows_kernel's stages): g, p (M, R, C) widened, vr (M, R), vc (M,
    C); returns new p, vr, vc."""
    M, R, C = g.shape
    vec, SR, S = plan["vec"], plan["slab_rows"], plan["slabs_a_matrix"]
    CW = 32 * vec
    Kc = -(-C // CW)
    omb = F(1) - b
    x = slab_walk(g * g + F(EPS1), SR, S, vec)
    cols = tree(chain(x, 2), 2).reshape(M, S, Kc * CW)[..., :C]       # warps' chains, warps
    cols = tree(cols, 1) if S > 1 else cols[:, 0]
    vc_new = b * vc + omb * (cols / F(R))
    steps = x.shape[2]
    rows = tree(x.reshape(M, S, steps * 8, Kc, CW), -1)               # a chunk's tree
    rows = chain(rows, -1)[:, :, :SR].reshape(M, S * SR)[:, :R]       # chunks in order
    vr_new = b * vr + omb * (rows / F(C))
    slab_vr = np.zeros((M, S * SR), F)
    slab_vr[:, :R] = vr_new
    vsum = tree(slab_vr.reshape(M, S, SR), -1)
    vsum = tree(vsum, 1) if S > 1 else vsum[:, 0]
    rmean = np.maximum(vsum / F(R), F(EPS1))
    ppart = thread_partials(slab_walk(p * p, SR, S, vec), vec)
    d = (vr_new / rmean[:, None])[:, :, None] * vc_new[:, None, :]
    u = rsqrt(np.maximum(d, F(EPS1))) * g
    upart = thread_partials(slab_walk(u * u, plan["slab_rows2"], plan["slabs_a_matrix2"], vec),
                            vec)
    dclip, ls, lwd = tail_scalars(upart, ppart, M * R * C, lr)
    return (p - (u / dclip) * ls) - lwd * p, vr_new, vc_new


def emulate_flat(g, p, v, plan, lr, b):
    """The kernels' update of a group that is not factored: g, p, v flat."""
    vec, G = plan["vec"], plan["grid"]
    n_all = g.size
    span = G * AF.THREADS * vec
    iters = -(-n_all // span)

    def walked(a):     # -> (iters, G, 8, 32, vec)
        out = np.zeros(iters * span, F)
        out[:n_all] = a
        return out.reshape(iters, G, 8, 32, vec)

    def partials(a):
        t = chain(tree(walked(a), -1), 0)                   # (G, 8, 32)
        return tree(tree(t, -1), -1)

    v_new = b * v + (F(1) - b) * (g * g + F(EPS1))
    u = g * rsqrt(np.maximum(v_new, F(EPS1)))
    dclip, ls, lwd = tail_scalars(partials(u * u), partials(p * p), n_all, lr)
    return (p - (u / dclip) * ls) - lwd * p, v_new


def emulate(group_g, group_p, state, step):
    """The kernels' update of a port group, emulated; returns (p array in
    the group's array shape, new state as numpy, whether the statistics'
    sum of u^2 stood)."""
    shape, stacked = AF.group_shape(group_p, state)
    plan = AF.launch_plan(shape, len(group_p), group_g[0].dtype, group_p[0].dtype, 8, SMS)
    sc = scalars(step)
    lr, b = F(sc["lr"].item()), F(sc["beta2"].item())
    arr = lambda ts: np.stack([t.float().numpy() for t in ts]).reshape(shape)  # noqa: E731
    g, p = arr(group_g), arr(group_p)
    if plan["factored"]:
        R, C = shape[-2:]
        args = (g.reshape(-1, R, C), p.reshape(-1, R, C), state["vr"].numpy().reshape(-1, R),
                state["vc"].numpy().reshape(-1, C), plan, lr, b)
        if plan["path"] == "rows":
            new_p, vr, vc, guard = emulate_rows(*args)
        else:
            (new_p, vr, vc), guard = emulate_wide(*args), False
        return new_p.reshape(shape), {"vr": vr.reshape(state["vr"].shape),
                                      "vc": vc.reshape(state["vc"].shape)}, guard
    new_p, v = emulate_flat(g.reshape(-1), p.reshape(-1), state["v"].numpy().reshape(-1),
                            plan, lr, b)
    return new_p.reshape(shape), {"v": v.reshape(shape)}, True


def rel(a, b) -> float:
    """The largest elementwise |a - b| / |b| (b > 0: second moments)."""
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                        / np.abs(np.asarray(b, np.float64))))


def check_against_plain(layers, shape, dtype, steps, scales, seed, name=""):
    """``steps`` plain steps, then the emulated and the plain update from the
    same state; the card's tolerances.  Returns the two states and whether
    the emulated statistics' sum of u^2 stood."""
    rng = np.random.default_rng(seed)
    p, gs = arrays(rng, layers, shape, scales, name)
    tp = [t.to(dtype) for t in as_group(p, layers)]
    ts = port_state(p.shape)
    for step in range(1, steps):
        AF.adafactor_update_plain([t.to(dtype) for t in as_group(gs[step - 1], layers)], tp, ts,
                                  **scalars(step), **HP)
    g_last = [t.to(dtype) for t in as_group(gs[steps - 1], layers)]
    before = np.stack([t.float().numpy() for t in tp]).reshape(p.shape)
    got_p, got_s, guard = emulate(g_last, tp, ts, steps)
    AF.adafactor_update_plain(g_last, tp, ts, **scalars(steps), **HP)
    want_p = np.stack([t.float().numpy() for t in tp]).reshape(p.shape)
    for k in ts:
        assert rel(got_s[k], ts[k].numpy()) <= STATE_TOL, k
    if dtype == torch.float32:
        d_got, d_want = got_p - before, want_p - before
        assert np.linalg.norm(d_got - d_want) <= UPDATE_TOL * np.linalg.norm(d_want)
    else:
        got_bits = torch.from_numpy(got_p).to(dtype).view(torch.int16).numpy().astype(np.int32)
        want_bits = torch.from_numpy(want_p).to(dtype).view(torch.int16).numpy().astype(np.int32)
        assert np.abs(got_bits - want_bits).max() <= 1      # one bf16 ulp (same signs)
    return got_s, ts, guard


EMULATED = [
    # af_rows_kernel: 6 slabs of 16 rows, a thread's one (bf16) or two (fp32)
    # column vectors, the grid's column sums
    ("matrix", None, (96, 4096)),
    ("narrow", None, (1024, 512)),              # row groups (2 to 16 rows at once), 64 slabs
    ("stacked_vectors", 12, (4096,)),           # recurrentgemma's stacked norm weights: one slab
    ("heads", 3, (4, 16, 1024)),                # 12 matrices of 16 rows, one slab each, row groups
    ("guard_fails", None, (128, 1024)),         # the u^2 pass runs (a clamp bites on a nonzero g)
    # the wide walk: a row wider than the stages, or tiles under MIN_TILE_BYTES
    ("wide", None, (24, 16384)),
    ("small", None, (300, 200)),
    ("stacked_matrices", 3, (130, 72)),
    ("skinny", None, (2000, 8)),
    ("odd", None, (333, 77)),                   # vec 1
    # not factored
    ("vector", None, (4099,)),
    ("scalar", None, ()),
    ("last_dim_1", None, (12, 1)),
    ("stacked_last_dim_1", 3, (40, 1, 24)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("step,regime", [(1, "no_clip"), (3, "clip"), (3, "no_clip"),
                                         (1, "zero")])
@pytest.mark.parametrize("name,layers,shape", EMULATED)
def test_the_kernels_plan_holds_to_the_plain_version(name, layers, shape, step, regime, dtype):
    _, _, guard = check_against_plain(layers, shape, dtype, step, REGIMES[regime],
                                      seed=zlib.crc32(f"{name}/{step}/{regime}".encode()),
                                      name=name)
    plan = AF.launch_plan((layers, *shape) if layers else shape, layers or 1, dtype, dtype, 8,
                          SMS)
    if plan["path"] == "rows":
        assert guard == (name != "guard_fails" or regime == "zero")


def elementwise_usq(g, vr, vc):
    """sum u^2 of a factored group (g (M, R, C), its new vr and vc) as the
    reference forms u, in float64."""
    rm = np.maximum(vr.mean(-1), EPS1)
    d = (vr / rm[:, None])[:, :, None] * vc[:, None, :]
    return float(np.sum(g * g / np.maximum(d, EPS1)))


def factorised_usq(g, vr, vc):
    """The statistics pass's form in float64: sum_m m_m sum_j W_j / vc_j with
    W_j = sum_i g_ij^2 / vr_i, and its guard: over the rows and columns that
    hold a nonzero g^2, (min vr / m) vc_j >= eps1."""
    rm = np.maximum(vr.mean(-1), EPS1)
    g2 = g * g
    W = np.einsum("mij,mi->mj", g2, 1.0 / vr)
    total = float(np.sum(rm * np.sum(W / vc, -1)))
    rows, cols = (g2 > 0).any(-1), (g2 > 0).any(-2)
    mv = np.where(rows, vr, np.inf).min(-1)
    guard = bool(np.all(~cols | ((mv / rm)[:, None] * vc >= EPS1)))
    return total, guard


@pytest.mark.parametrize("name,shape,holds", [
    ("matrix", (1, 48, 64), True),
    ("stacked", (6, 16, 24), True),
    ("zero_rows", (2, 40, 32), True),       # rows of g exactly 0 beside rows of 1e2
    ("guard_fails", (1, 64, 48), False),
])
def test_the_factorised_sum_of_squares(name, shape, holds):
    """In float64 at step 3 of a fresh state (beta2 = 1 - 3^-0.8): the
    factorised sum of u^2 equals the elementwise one within 1e-6 wherever
    the guard holds, and the guard fails where a clamp bites on a nonzero g."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    g = rng.standard_normal(shape)
    if name == "zero_rows":
        g *= np.where(np.arange(shape[1]) % 3 == 0, 0.0, 1e2)[:, None]
    if name.startswith("guard"):
        _, (g,) = arrays(rng, None, shape[1:], (1.0,), name)
        g = g.astype(np.float64)[None]
    b = 1.0 - 3.0 ** -0.8
    g2 = g * g + EPS1
    vr, vc = (1 - b) * g2.mean(-1), (1 - b) * g2.mean(-2)
    total, guard = factorised_usq(g, vr, vc)
    assert guard == holds
    want = elementwise_usq(g, vr, vc)
    rm = np.maximum(vr.mean(-1), EPS1)
    d = (vr / rm[:, None])[:, :, None] * vc[:, None, :]
    assert bool(np.any((g != 0) & (d < EPS1))) == (not holds)   # a clamp bites on a nonzero g
    if holds:
        assert abs(total - want) <= 1e-6 * want


def test_a_skinny_leaf_keeps_its_long_column_sums():
    """100,000 rows of 8 columns (tiles of 16 KB: the wide walk): slabs of 192
    rows (521 of them), each column summed by 8 warps' chains of 24 rows, a
    tree over the warps and one over the slabs: within 1e-5 of the exact sum,
    and of the plain version's, as the plan's shorter sums are too."""
    R, C = 100_000, 8
    plan = AF.launch_plan((R, C), 1, torch.float32, torch.float32, 8, SMS)
    assert (plan["path"], plan["slab_rows"], plan["slabs_a_matrix"]) == ("wide", 192, 521)
    got, want, _ = check_against_plain(None, (R, C), torch.float32, 1, (1.0,), seed=5)
    rng = np.random.default_rng(5)
    _, gs = arrays(rng, None, (R, C), (1.0,))
    exact = (gs[0].astype(np.float64) ** 2 + EPS1).mean(0)
    assert rel(got["vc"], exact) <= 1e-5
    assert rel(want["vc"].numpy(), exact) <= 1e-5


def test_the_plan_over_recurrentgemmas_tree():
    """recurrentgemma-9b's 71 groups (56 factored) at the card's 132 SMs: the
    kernels a step launches (3 a factored group, 2 a plain one: 198), every
    factored group on af_rows_kernel (the tied embedding: 132 slabs of 1944
    rows in tiles of 4, three stages, a block an SM) but 12 x 4096 x 16 x
    256 (matrices of 16 x 256: tiles of 16 KB, the wide walk), and a
    workspace under 16 MiB (12 x 4096 x 12288's: 11 slabs a matrix, column
    partials of g^2 + eps1 and of W, 12.4 MiB)."""
    cfg = get_config("recurrentgemma-9b")
    groups = TO._groups(abstract_params(cfg), cfg)
    plans = [AF.launch_plan(TO._stack_shape(g), len(g), torch.bfloat16, torch.bfloat16, 8, SMS)
             for g in groups]
    assert (len(plans), sum(p["factored"] for p in plans)) == (71, 56)
    assert all(p["vec"] == (8 if p["factored"] else 4) for p in plans)
    wide = [(TO._stack_shape(g), p) for g, p in zip(groups, plans) if p["path"] == "wide"]
    assert [s for s, _ in wide] == [(12, 4096, 16, 256)]
    assert all(p["path"] in ("rows", "wide") for p in plans if p["factored"])
    emb = max(plans, key=lambda p: p.get("R", 0))
    assert (emb["R"], emb["slab_rows"], emb["slabs_a_matrix"], emb["tile_rows"],
            emb["stages"]) == (256000, 1944, 132, 4, 3)
    assert max(p["workspace"] for p in plans) * 4 <= 16 * 2**20
    assert sum(p["kernels"] for p in plans) == 3 * 56 + 2 * 15 == 198


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "phi4-mini-3.8b"])
def test_plain_kernels_is_the_same_optimizer_on_the_cpu(arch):
    from repro_torch.models import Model
    cfg = get_tiny_config(arch).replace(dtype="float32", param_dtype="float32")
    base = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    out = []
    for plain in (False, True):
        params = TO.tree_map(lambda t: t.detach().clone(), base)
        opt = TO.adafactor(TO.cosine_schedule(LR, warmup=1), cfg=cfg, plain_kernels=plain)
        state = opt.init(params)
        for _ in range(2):
            gen.manual_seed(2)
            grads = TO.tree_map(lambda t: torch.randn(t.shape, generator=gen), params)
            params, state = opt.update(grads, state, params)
        out.append((TO.tree_leaves(params), [t for s in state["f"] for t in s.values()]))
    for a, b in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        assert torch.equal(a, b)
    assert math.isfinite(float(sum(t.sum() for t in out[0][0])))
