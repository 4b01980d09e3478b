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
]
# the gradient's scale at each of three steps: step 3's large gradient
# against the moments of steps 1-2 makes the update's RMS exceed the
# threshold; a small one keeps it under
REGIMES = {"clip": (1.0, 1.0, 100.0), "no_clip": (1.0, 1.0, 0.01), "zero": (0.0, 0.0, 0.0)}


def arrays(rng, layers, shape, scales):
    full = shape if layers is None else (layers, *shape)
    p = rng.standard_normal(full).astype(np.float32) * np.float32(0.5)
    gs = [(rng.standard_normal(full) * s).astype(np.float32) for s in scales]
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
    p, gs = arrays(rng, layers, shape, REGIMES[regime])
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


def chain(x, axis=0):
    """A sequential float32 sum along ``axis``, from 0."""
    x = np.moveaxis(np.asarray(x, F), axis, 0)
    acc = np.zeros(x.shape[1:], F)
    for t in x:
        acc = acc + t
    return acc


def rsqrt(d):
    return F(1) / np.sqrt(d)


def scalar_kernel(upart, ppart, N, lr):
    """af_scalars_kernel: 1024 threads each add every 1024th partial, then a tree."""
    T = AF.SCALAR_THREADS
    out = []
    for part in (upart, ppart):
        k = -(-len(part) // T)
        padded = np.zeros(k * T, F)
        padded[:len(part)] = part
        out.append(tree(chain(padded.reshape(k, T), 0)))
    us, ps = out
    N = F(N)
    rms = np.sqrt(us / N + F(EPS1))
    d = max(rms / F(CLIP), F(1))
    scale = max(np.sqrt(ps / N), F(EPS2))
    return d, F(lr) * scale, F(lr) * F(WD)


def thread_partials(v, vec):
    """Per slab: each thread's chain over (chunk, step) of its vector trees,
    then the warp's tree, then the block's.  ``v``: (M, S, steps, 8 warps,
    chunks, 32 lanes, vec)."""
    t = tree(v, -1)                                       # (M, S, steps, 8, K, 32)
    t = np.transpose(t, (0, 1, 3, 5, 4, 2))               # (M, S, 8, 32, K, steps)
    t = chain(t.reshape(*t.shape[:4], -1), -1)            # k outer, step inner
    return tree(tree(t, -1), -1).reshape(-1)              # lanes, then warps


def emulate_factored(g, p, vr, vc, plan, lr, b):
    """The kernels' update of a factored group in float32: g, p (M, R, C)
    widened, vr (M, R), vc (M, C); returns new p, vr, vc."""
    M, R, C = g.shape
    vec, SR, S = plan["vec"], plan["slab_rows"], plan["slabs_a_matrix"]
    CW = 32 * vec
    Kc = -(-C // CW)
    steps = -(-SR // 8)
    omb = F(1) - b

    def slabbed(a):    # (M, R, C) -> (M, S, steps, 8, Kc, 32, vec), zeros where no element
        # (S, SR and steps as the enclosing function holds them when called)
        out = np.zeros((M, S * SR, C), F)
        out[:, :R] = a
        out = out.reshape(M, S, SR, C)
        pad = np.zeros((M, S, steps * 8, Kc * CW), F)
        pad[:, :, :SR, :C] = out
        return pad.reshape(M, S, steps, 8, Kc, 32, vec)

    x = slabbed(g * g + F(EPS1))
    cols = tree(chain(x, 2), 2).reshape(M, S, Kc * CW)[..., :C]       # warps' chains, warps
    cols = tree(cols, 1) if S > 1 else cols[:, 0]
    vc_new = b * vc + omb * (cols / F(R))
    rows = tree(x.reshape(M, S, steps * 8, Kc, CW), -1)               # a chunk's tree
    rows = chain(rows, -1)[:, :, :SR].reshape(M, S * SR)[:, :R]       # chunks in order
    vr_new = b * vr + omb * (rows / F(C))
    slab_vr = np.zeros((M, S * SR), F)
    slab_vr[:, :R] = vr_new
    vsum = tree(slab_vr.reshape(M, S, SR), -1)
    vsum = tree(vsum, 1) if S > 1 else vsum[:, 0]
    rmean = np.maximum(vsum / F(R), F(EPS1))
    ppart = thread_partials(slabbed(p * p), vec)
    d = (vr_new / rmean[:, None])[:, :, None] * vc_new[:, None, :]
    u = rsqrt(np.maximum(d, F(EPS1))) * g
    # the update's passes walk slabs of their own (no column partials)
    SR, S = plan["slab_rows2"], plan["slabs_a_matrix2"]
    steps = -(-SR // 8)
    upart = thread_partials(slabbed(u * u), vec)
    dclip, ls, lwd = scalar_kernel(upart, ppart, M * R * C, lr)
    new_p = (p - (u / dclip) * ls) - lwd * p
    return new_p, vr_new, vc_new


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
    dclip, ls, lwd = scalar_kernel(partials(u * u), partials(p * p), n_all, lr)
    return (p - (u / dclip) * ls) - lwd * p, v_new


def emulate(group_g, group_p, state, step):
    """The kernels' update of a port group, emulated; returns (p array in
    the group's array shape, new state as numpy)."""
    shape, stacked = AF.group_shape(group_p, state)
    plan = AF.launch_plan(shape, len(group_p), group_g[0].dtype, group_p[0].dtype, 8, SMS)
    sc = scalars(step)
    lr, b = F(sc["lr"].item()), F(sc["beta2"].item())
    arr = lambda ts: np.stack([t.float().numpy() for t in ts]).reshape(shape)  # noqa: E731
    g, p = arr(group_g), arr(group_p)
    if plan["factored"]:
        R, C = shape[-2:]
        new_p, vr, vc = emulate_factored(g.reshape(-1, R, C), p.reshape(-1, R, C),
                                         state["vr"].numpy().reshape(-1, R),
                                         state["vc"].numpy().reshape(-1, C), plan, lr, b)
        return new_p.reshape(shape), {"vr": vr.reshape(state["vr"].shape),
                                      "vc": vc.reshape(state["vc"].shape)}
    new_p, v = emulate_flat(g.reshape(-1), p.reshape(-1), state["v"].numpy().reshape(-1),
                            plan, lr, b)
    return new_p.reshape(shape), {"v": v.reshape(shape)}


def rel(a, b) -> float:
    """The largest elementwise |a - b| / |b| (b > 0: second moments)."""
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                        / np.abs(np.asarray(b, np.float64))))


def check_against_plain(layers, shape, dtype, steps, scales, seed):
    """``steps`` plain steps, then the emulated and the plain update from the
    same state; the card's tolerances."""
    rng = np.random.default_rng(seed)
    p, gs = arrays(rng, layers, shape, scales)
    tp = [t.to(dtype) for t in as_group(p, layers)]
    ts = port_state(p.shape)
    for step in range(1, steps):
        AF.adafactor_update_plain([t.to(dtype) for t in as_group(gs[step - 1], layers)], tp, ts,
                                  **scalars(step), **HP)
    g_last = [t.to(dtype) for t in as_group(gs[steps - 1], layers)]
    before = np.stack([t.float().numpy() for t in tp]).reshape(p.shape)
    got_p, got_s = emulate(g_last, tp, ts, steps)
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
    return got_s, ts


EMULATED = [
    ("matrix", None, (300, 200)),               # slabs of 64 rows, chunks of 128 and 256
    ("stacked_matrices", 3, (130, 72)),
    ("stacked_vectors", 12, (4096,)),           # recurrentgemma's stacked norm weights
    ("skinny", None, (2000, 8)),
    ("odd", None, (333, 77)),                   # vec 1
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
    check_against_plain(layers, shape, dtype, step, REGIMES[regime],
                        seed=zlib.crc32(f"{name}/{step}/{regime}".encode()))


def test_a_skinny_leaf_keeps_its_long_column_sums():
    """100,000 rows of 8 columns: slabs of 192 rows (521 of them), each
    column summed by 8 warps' chains of 24 rows, a tree over the warps and
    one over the slabs: within 1e-5 of the exact sum, and of the plain
    version's, as the plan's shorter sums are too."""
    R, C = 100_000, 8
    plan = AF.launch_plan((R, C), 1, torch.float32, torch.float32, 8, SMS)
    assert (plan["slab_rows"], plan["slabs_a_matrix"]) == (192, 521)
    got, want = check_against_plain(None, (R, C), torch.float32, 1, (1.0,), seed=5)
    rng = np.random.default_rng(5)
    _, gs = arrays(rng, None, (R, C), (1.0,))
    exact = (gs[0].astype(np.float64) ** 2 + EPS1).mean(0)
    assert rel(got["vc"], exact) <= 1e-5
    assert rel(want["vc"].numpy(), exact) <= 1e-5


def test_the_plan_over_recurrentgemmas_tree():
    """recurrentgemma-9b's 71 groups (56 factored) at the card's 132 SMs: the
    kernels a step launches, and a workspace of a few MB at most (the tied
    embedding's: 525 slabs of 488 rows, 4096 columns, 8.6 MB)."""
    cfg = get_config("recurrentgemma-9b")
    groups = TO._groups(abstract_params(cfg), cfg)
    plans = [AF.launch_plan(TO._stack_shape(g), len(g), torch.bfloat16, torch.bfloat16, 8, SMS)
             for g in groups]
    assert (len(plans), sum(p["factored"] for p in plans)) == (71, 56)
    assert all(p["vec"] == (8 if p["factored"] else 4) for p in plans)
    emb = max(plans, key=lambda p: p.get("R", 0))
    assert (emb["R"], emb["slab_rows"], emb["slabs_a_matrix"]) == (256000, 488, 525)
    assert max(p["workspace"] for p in plans) * 4 <= 10.5 * 2**20
    assert sum(p["kernels"] for p in plans) == (
        5 * sum(p.get("slabs_a_matrix", 1) > 1 for p in plans)
        + 4 * sum(p["factored"] and p["slabs_a_matrix"] == 1 for p in plans)
        + 3 * sum(not p["factored"] for p in plans))


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
