"""The xLSTM family (xlstm-125m: ``mlstm`` and ``slstm`` blocks) in
``repro_torch`` against the reference, on the CPU.

Inputs are made with numpy and handed to both packages.  The models' weights
are the reference's init with numpy noise on every leaf, carried by
``repro_torch.convert``; the mLSTM's conv filter and bias and its gate bias
are drawn from the seed at full scale.  The reference's init leaves those at
0 (its creator treats them as biases): then ``q = k = 0`` and every mLSTM
block adds exactly 0, so a parity test would pass whatever the cell computes.

Tolerances:

* float32 2e-6 (absolute and relative) for the sLSTM and the mLSTM's step,
  as ``tests/test_kernels.py``; the chunkwise mLSTM 1e-5 (absolute and
  relative), measured 4e-6: its products contract over the chunk and the
  head dim in another order than XLA's, and its cumulative log-forget sums
  in another order (outputs up to 6 in magnitude);
* bfloat16 2e-2, as ``tests/test_kernels.py``, but for the mLSTM block in
  bfloat16: 1e-1 (measured 0.090 on outputs up to 3).  XLA keeps float32
  inside a fusion where eager torch rounds each op's bf16 output (the conv's
  products and sums, the gates), and the exponential input gate amplifies
  those roundings: against the same block in float32 the reference's error
  is 0.051 and the port's 0.108 (mean 0.0054 and 0.0058), which
  ``test_mlstm_block_bfloat16_error_is_near_the_references`` holds;
* model logits 1e-4 in float32, as ``tests/test_torch_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config, get_tiny_config as j_tiny
from repro.models import Model as JModel
from repro.models import layers as JL, model as JM
from repro.serving import Request as JRequest, ServingEngine as JEngine
from repro_torch.configs import get_config as t_config, get_tiny_config as t_tiny
from repro_torch.convert import from_reference_cache, from_reference_params
from repro_torch.models import Model as TModel
from repro_torch.models import layers as TL, model as TM
from repro_torch.models.kvcache import cache_bytes, cache_len_of
from repro_torch.models.params import count_params
from repro_torch.serving import Request, ServingEngine

ARCH = "xlstm-125m"
TOL = {"float32": 2e-6, "bfloat16": 2e-2}
CHUNK_TOL = 1e-5
MLSTM_BF16_TOL = 1e-1
MODEL_TOL = 1e-4
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(got, want, tol):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)), atol=tol, rtol=tol)


def data(rng, shape, dtype="float32", scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, J_DT[dtype]), torch.from_numpy(x).to(T_DT[dtype])


def mlstm_inputs(rng, B, S, H, D, dtype="float32", state=False):
    """q, k, v (B,S,H,D), gates (B,S,H), an optional (C, n, m) state, as
    (reference arrays, port tensors)."""
    qkv = [data(rng, (B, S, H, D), dtype) for _ in range(3)]
    gates = [data(rng, (B, S, H), dtype) for _ in range(2)]
    args = qkv + gates
    j, t = [a for a, _ in args], [b for _, b in args]
    if state:
        st = [data(rng, s) for s in ((B, H, D, D), (B, H, D), (B, H))]
        return j, t, tuple(a for a, _ in st), tuple(b for _, b in st)
    return j, t, None, None


# ---------------- the cells ----------------

@pytest.mark.parametrize("state", [False, True], ids=["no-state", "state"])
@pytest.mark.parametrize("S", [32, 64])
def test_mlstm_chunkwise_matches_the_reference(S, state):
    """S a multiple of the chunk (16): two and four chunks, from no state and
    from a random one; outputs and the returned state."""
    rng = np.random.default_rng(S + state)
    j, t, sj, st = mlstm_inputs(rng, 2, S, 2, 8, state=state)
    yj, statej = JL.mlstm_chunkwise(*j, sj, chunk=16)
    yt, statet = TL.mlstm_chunkwise(*t, st, chunk=16)
    close(yt, yj, CHUNK_TOL)
    for a, b in zip(statet, statej, strict=True):
        assert a.dtype == torch.float32
        close(a, b, CHUNK_TOL)


@pytest.mark.parametrize("state", [False, True], ids=["no-state", "state"])
def test_mlstm_padded_chunk_wipes_the_state_in_both_packages(state):
    """S = 40 with a chunk of 16 pads 8 steps with forget gates of -1e9.  The
    outputs are right, but the padded steps wipe the returned state: C = 0,
    n = 0, m = 0 in the reference, whatever state came in and whatever the
    40 steps wrote.  The port keeps that fault bit for bit (ROADMAP queue C:
    fixed in both packages or in neither)."""
    rng = np.random.default_rng(40 + state)
    j, t, sj, st = mlstm_inputs(rng, 2, 40, 2, 8, state=state)
    yj, statej = JL.mlstm_chunkwise(*j, sj, chunk=16)
    yt, statet = TL.mlstm_chunkwise(*t, st, chunk=16)
    close(yt, yj, CHUNK_TOL)
    assert yt.shape == (2, 40, 2, 8) and yt.is_contiguous()
    for a, b in zip(statet, statej, strict=True):
        assert not np.asarray(b).any() and not a.any()          # wiped in both
    # the first 32 steps alone leave a state of magnitude several units
    _, (C, _, _) = TL.mlstm_chunkwise(*(x[:, :32] for x in t), st, chunk=16)
    assert float(C.abs().max()) > 1.0


def test_mlstm_chunkwise_bfloat16_matches_the_reference():
    rng = np.random.default_rng(7)
    j, t, _, _ = mlstm_inputs(rng, 2, 32, 2, 8, dtype="bfloat16")
    yj, _ = JL.mlstm_chunkwise(*j, chunk=16)
    yt, _ = TL.mlstm_chunkwise(*t, chunk=16)
    assert yt.dtype == torch.bfloat16
    close(yt, yj, TOL["bfloat16"])


@pytest.mark.parametrize("state", ["zero", "random"])
def test_mlstm_step_matches_the_reference(state):
    """One token from a fresh cache's state (zeros) and from a random one;
    the port updates the given tensors in place, the reference returns new
    arrays with the same values."""
    rng = np.random.default_rng(11)
    B, H, D = 2, 2, 8
    args = [data(rng, (B, H, D)) for _ in range(3)] + [data(rng, (B, H)) for _ in range(2)]
    if state == "zero":
        st = [(jnp.zeros(s), torch.zeros(s)) for s in ((B, H, D, D), (B, H, D), (B, H))]
    else:
        st = [data(rng, s) for s in ((B, H, D, D), (B, H, D), (B, H))]
    yj, sj = JL.mlstm_step(*(a for a, _ in args), tuple(a for a, _ in st))
    mine = tuple(b.clone() for _, b in st)
    yt, stt = TL.mlstm_step(*(b for _, b in args), mine)
    assert all(a is b for a, b in zip(stt, mine))
    close(yt, yj, TOL["float32"])
    for a, b in zip(stt, sj, strict=True):
        close(a, b, TOL["float32"])


def test_mlstm_chunkwise_equals_the_step_by_step_recurrence():
    """Within the port: the chunkwise form over 32 steps (two chunks) equals
    32 ``mlstm_step`` calls from the chunkwise form's initial state."""
    rng = np.random.default_rng(5)
    B, S, H, D = 2, 32, 2, 8
    _, (q, k, v, i, f), _, _ = mlstm_inputs(rng, B, S, H, D)
    y, (C, n, m) = TL.mlstm_chunkwise(q, k, v, i, f, chunk=16)
    state = (torch.zeros(B, H, D, D), torch.zeros(B, H, D), torch.full((B, H), TL.NEG_INF))
    ys = [TL.mlstm_step(q[:, s], k[:, s], v[:, s], i[:, s], f[:, s], state)[0]
          for s in range(S)]
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y.numpy(), atol=CHUNK_TOL,
                               rtol=CHUNK_TOL)
    # the stabiliser differs (m against the chunk's), the state C e^m does not
    for a, b in ((C, state[0]), (n, state[1])):
        dm = (m - state[2]).exp()
        a = a * dm.reshape(*dm.shape, *(1,) * (a.ndim - 2))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=CHUNK_TOL, rtol=CHUNK_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True], ids=["no-state", "state"])
def test_slstm_scan_matches_the_reference(state, dtype):
    rng = np.random.default_rng(13)
    B, S, W = 2, 12, 16
    xj, xt = data(rng, (B, S, 4 * W), dtype)
    rj, rt = data(rng, (W, 4 * W), dtype, scale=0.25)
    sj = st = None
    if state:
        pairs = [data(rng, (B, W)) for _ in range(4)]
        pairs[1] = tuple(abs(a) + 0.5 for a in pairs[1])       # n > 0, as a run leaves it
        sj, st = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
    yj, statej = JL.slstm_scan({"r": rj}, xj, sj)
    yt, statet = TL.slstm_scan({"r": rt}, xt, st)
    assert yt.dtype == T_DT[dtype] and yt.is_contiguous()
    close(yt, yj, TOL[dtype])
    for a, b in zip(statet, statej, strict=True):
        assert a.dtype == torch.float32
        close(a, b, TOL[dtype])


def test_scan_is_lax_scan():
    """``layers.scan`` has ``lax.scan``'s contract: the last carry and the
    stacked outputs (a tuple of them here), over dim 0 of every input."""
    xs = (np.arange(12.0).reshape(4, 3), np.ones((4, 2)))

    def jstep(c, x):
        return c + x[0].sum(), (c * x[1], x[0])

    def tstep(c, x):
        return c + x[0].sum(), (c * x[1], x[0])

    cj, yj = jax.lax.scan(jstep, jnp.float32(1.0), tuple(jnp.asarray(x, jnp.float32) for x in xs))
    ct, yt = TL.scan(tstep, torch.tensor(1.0), tuple(torch.tensor(x, dtype=torch.float32)
                                                      for x in xs))
    assert float(ct) == float(cj)
    for a, b in zip(yt, yj, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------- blocks and the model ----------------

def reference_params(dtype="float32", seed=0, **replace):
    """(reference cfg, port cfg, reference params, the same as float32
    numpy): the reference's init with numpy noise on every leaf, and the
    mLSTM's conv filter, conv bias and gate bias drawn at full scale."""
    cj = j_tiny(ARCH).replace(dtype=dtype, param_dtype=dtype, **replace)
    ct = t_tiny(ARCH).replace(dtype=dtype, param_dtype=dtype, **replace)
    params = JModel(cj).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def noise(path, a):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        drawn = "conv" in keys or keys[-2:] == ["gates", "b"]
        scale = 0.5 if drawn else 0.05
        return (a.astype(jnp.float32) + jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32) * scale)).astype(a.dtype)

    params = jax.tree_util.tree_map_with_path(noise, params)
    return cj, ct, params, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_config_and_sizes_are_the_references():
    """The full config and its parameter count (149,424,456) and cache bytes
    equal the reference's; the cycle is m, m, m, s over 12 layers."""
    from repro.models.kvcache import cache_bytes as j_cache_bytes
    from repro.models.params import count_params as j_count
    cj, ct = j_config(ARCH), t_config(ARCH)
    assert {f: getattr(ct, f) for f in ct.__dataclass_fields__} == \
        {f: getattr(cj, f) for f in cj.__dataclass_fields__}
    assert count_params(ct) == j_count(cj) == 149_424_456
    assert cache_bytes(ct, 8, 2048) == j_cache_bytes(cj, 8, 2048)
    assert TModel(ct, "cpu").kinds == ("mlstm", "mlstm", "mlstm", "slstm") * 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,layer", [("mlstm", 0), ("slstm", 3)])
def test_blocks_match_the_reference_in_full_and_decode_mode(kind, layer, dtype):
    """One block of each kind: a prefill of 32 tokens (two chunks: its output
    and its state), then a decode step against that state, written in place.
    The port's block returns the residual stream and the add it leaves
    pending; their sum is the reference's output."""
    tol = MLSTM_BF16_TOL if (kind, dtype) == ("mlstm", "bfloat16") else TOL[dtype]
    cj, ct, pj, pn = reference_params(dtype)
    pt = from_reference_params(pn, ct, "cpu")["blocks"][layer]
    pjl = jax.tree.map(lambda a: a[layer // len(cj.block_pattern)],
                       pj["blocks"]["cycle"][layer % len(cj.block_pattern)])
    rng = np.random.default_rng(3)
    B, S = 2, 32
    hj, ht = data(rng, (B, S, ct.d_model), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, cache_j, _ = JM.apply_block_full(cj, kind, pjl, hj, {"positions": jnp.asarray(pos),
                                                               "cache_len": S}, True)
    h, f, cache_t, aux = TM.apply_block_full(ct, kind, pt, ht, None, {
        "positions": torch.from_numpy(pos.copy()), "cache_len": S}, True)
    assert aux is None
    close(h + f, want, tol)
    assert set(cache_t) == set(cache_j)
    for name in cache_t:
        close(cache_t[name], cache_j[name], tol)
    xj, xt = data(rng, (B, 1, ct.d_model), dtype)
    pos1 = np.full((B,), S, np.int32)
    want, new_j = JM.apply_block_decode(cj, kind, pjl, xj, cache_j, {"pos": jnp.asarray(pos1)})
    h, f, new_t = TM.apply_block_decode(ct, kind, pt, xt, None, cache_t,
                                        {"pos": torch.from_numpy(pos1)})
    assert all(new_t[n] is cache_t[n] for n in cache_t)     # written in place
    close(h + f, want, tol)
    for name in new_t:
        close(new_t[name], new_j[name], tol)


def test_mlstm_block_bfloat16_error_is_near_the_references():
    """Both packages' bf16 mLSTM block against the same block in float32
    (the bf16 weights and input widened): the port's largest error is within
    2.5 times the reference's own and its mean error within 1.25 times
    (measured 2.1 and 1.06)."""
    cj, ct, pj, pn = reference_params("bfloat16")
    pt = from_reference_params(pn, ct, "cpu")["blocks"][0]
    pjl = jax.tree.map(lambda a: a[0], pj["blocks"]["cycle"][0])
    c32 = cj.replace(dtype="float32", param_dtype="float32")
    hj, ht = data(np.random.default_rng(3), (2, 32, ct.d_model), "bfloat16")
    aux = {"positions": jnp.asarray(np.broadcast_to(np.arange(32), (2, 32))), "cache_len": 32}
    want, _, _ = JM.apply_block_full(cj, "mlstm", pjl, hj, aux, False)
    exact, _, _ = JM.apply_block_full(c32, "mlstm", jax.tree.map(lambda a: a.astype(jnp.float32),
                                                                 pjl),
                                      hj.astype(jnp.float32), aux, False)
    h, f, _, _ = TM.apply_block_full(ct, "mlstm", pt, ht, None, {
        "positions": torch.from_numpy(np.asarray(aux["positions"]).copy())}, False)
    exact = np.asarray(exact)
    ref_err = np.abs(np.asarray(want, np.float32) - exact)
    port_err = np.abs((h + f).float().numpy() - exact)
    assert port_err.max() <= 2.5 * ref_err.max()
    assert port_err.mean() <= 1.25 * ref_err.mean()


@pytest.mark.parametrize("prompt", [32, 20], ids=["whole-chunks", "padded-chunk"])
def test_tiny_model_forward_prefill_and_decode_match_the_reference(prompt):
    """The forward's logits, then a prefill and three decode steps on the
    converted cache.  A prompt of 20 tokens (chunk 16) pads its last chunk:
    both packages' prefills then hand the decode a wiped mLSTM state
    (ROADMAP queue C), and the two stay equal."""
    cj, ct, pj, pn = reference_params()
    pt = from_reference_params(pn, ct, "cpu")
    toks = tokens(cj, 2, prompt + 3)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    want, _ = jm.forward(pj, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(pt, {"tokens": toks})
    close(got, want, MODEL_TOL)
    lj, cache_j = jm.prefill(pj, {"tokens": jnp.asarray(toks[:, :prompt])}, cache_len=64)
    lt, cache_t = tm.prefill(pt, {"tokens": toks[:, :prompt]}, cache_len=64)
    close(lt, lj, MODEL_TOL)
    assert cache_len_of(cache_t) is None
    wiped = not cache_t["blocks"][0]["C"].any()
    assert wiped == (prompt % ct.chunk_size != 0)
    assert wiped == (not np.asarray(cache_j["blocks"]["cycle"][0]["C"]).any())
    want = from_reference_cache(jax.tree.map(np.asarray, cache_j), ct, "cpu")
    for mine, theirs in zip(cache_t["blocks"], want["blocks"], strict=True):
        assert set(mine) == set(theirs)
        for name in mine:
            assert mine[name].dtype == theirs[name].dtype
            close(mine[name], theirs[name].numpy(), MODEL_TOL)
    for i in range(3):
        step = toks[:, prompt + i:prompt + i + 1]
        lj, cache_j = jm.decode_step(pj, cache_j, {"tokens": jnp.asarray(step)})
        lt, cache_t = tm.decode_step(pt, cache_t, {"tokens": step})
        close(lt, lj, MODEL_TOL)


def test_converted_cache_decodes_as_the_reference():
    """A reference prefill's cache, converted, drives the port's decode to
    the reference's logits (C, n, m stay float32)."""
    cj, ct, pj, pn = reference_params()
    pt = from_reference_params(pn, ct, "cpu")
    toks = tokens(cj, 2, 18, seed=4)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    _, cache_j = jm.prefill(pj, {"tokens": jnp.asarray(toks[:, :16])}, cache_len=64)
    cache_t = from_reference_cache(jax.tree.map(np.asarray, cache_j), ct, "cpu")
    assert cache_t["blocks"][0]["C"].dtype == torch.float32
    for i in range(2):
        step = toks[:, 16 + i:17 + i]
        lj, cache_j = jm.decode_step(pj, cache_j, {"tokens": jnp.asarray(step)})
        lt, cache_t = tm.decode_step(pt, cache_t, {"tokens": step})
        close(lt, lj, MODEL_TOL)


def test_bf16_tree_keeps_the_state_in_float32():
    cj, ct, pj, pn = reference_params("bfloat16")
    _, cache_j = JModel(cj).prefill(pj, {"tokens": jnp.asarray(tokens(cj, 1, 8))}, cache_len=16)
    cache_t = from_reference_cache(jax.tree.map(lambda a: np.asarray(a, np.float32), cache_j),
                                   ct, "cpu")
    dts = {name: t.dtype for name, t in {**cache_t["blocks"][0], **cache_t["blocks"][3]}.items()}
    assert dts == {"conv": torch.bfloat16, "C": torch.float32, "n": torch.float32,
                   "m": torch.float32, "c": torch.float32, "h": torch.float32}


def test_train_loss_and_gradients_match_the_reference():
    """The loss and every gradient (autograd through both cells' loops, the
    conv and the gates) against ``jax.value_and_grad`` of the reference's
    loss, float32, 2e-5 as ``tests/test_torch_training.py``; S 40 pads the
    last chunk of 16."""
    from repro.training.train_step import make_loss_fn as j_loss
    from repro_torch.training import make_loss_fn
    from repro_torch.training.optimizer import tree_leaves
    cj, ct, pj, pn = reference_params()
    toks = tokens(cj, 2, 41, seed=5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    (lj, _), gj = jax.value_and_grad(j_loss(JModel(cj)), has_aux=True)(
        pj, jax.tree.map(jnp.asarray, batch))
    pt = from_reference_params(pn, ct, "cpu")
    for p in tree_leaves(pt):
        p.requires_grad_()
    lt, _ = make_loss_fn(TModel(ct, "cpu"))(pt, batch)
    gt = torch.autograd.grad(lt, tree_leaves(pt))
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=2e-5, rtol=2e-5)
    want = tree_leaves(from_reference_params(jax.tree.map(np.asarray, gj), ct, "cpu"))
    assert len(gt) == len(want)
    for a, b in zip(gt, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)
    conv = pt["blocks"][0]["conv"]["w"]
    assert float(gt[[p is conv for p in tree_leaves(pt)].index(True)].abs().max()) > 0


# ---------------- serving ----------------

def test_engine_tokens_equal_the_reference_engine():
    """Three requests on two slots, one prompt longer than a chunk (a padded
    one), through both engines: the same greedy tokens in the same slots."""
    cj, ct, pj, pn = reference_params()
    pt = from_reference_params(pn, ct, "cpu")
    prompts = [[1, 2, 3, 4], list(range(5, 25)), [5, 5, 5, 5, 5]]
    je = JEngine(cj, pj, slots=2, cache_len=64)
    te = ServingEngine(ct, pt, slots=2, cache_len=64, device="cpu")
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p, max_new_tokens=5))
        te.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    want = {r.rid: r.tokens for r in je.run_until_drained(max_steps=200)}
    got = {r.rid: r.tokens for r in te.run_until_drained(max_steps=200)}
    assert len(got) == 3 and all(len(t) == 5 for t in got.values())
    assert got == want
    assert [r.slot for r in sorted(te.finished, key=lambda r: r.rid)] == \
           [r.slot for r in sorted(je.finished, key=lambda r: r.rid)]


def test_launchers_take_the_arch_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve, train
    finished = serve.main(["--device", "cpu", "--requests", "2", "--slots", "2",
                           "--max-new", "3", "--arch", ARCH])
    assert len(finished) == 2 and all(len(r.tokens) == 3 for r in finished)
    train.main(["--device", "cpu", "--tiny", "--arch", ARCH, "--steps", "2", "--batch", "2",
                "--seq", "16", "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "xlstm-tiny on cpu" in out


# ---------------- the simulator's view ----------------

def test_profiling_engine_times_the_degenerate_products_as_the_port_runs_them():
    """The mLSTM chunk body's outer (N, 1, D) and matrix-vector (N, 1, K)
    products are batched products of 1-wide matrices: the tracer records
    their batch, the profiling engine keys them ``|b<batch>`` and times them
    as ``torch.bmm`` over that many matrices (here on the CPU, at the
    prefill's shapes), while the chunk's other products keep the 2-D fold.
    Its all-batch (N, 1, 1) products are multiplies, no product at all."""
    from repro_torch.core import model_ingest as t_ingest
    from repro_torch.core.backend import profiling as P
    pre = t_ingest.block_graphs(t_config(ARCH), 1, 512, "prefill")
    mm = [n for n in pre.blocks[0].fwd if n.kind == "matmul" and n.repeat == 2]
    degenerate = [n for n in mm if P.degenerate_batched(n)]
    assert sorted(n.attrs["mm_dims"] for n in degenerate) == [
        (768, 1, 256), (1024, 1, 192), (1024, 1, 256), (1024, 192, 1), (1024, 192, 1)]
    assert all(n.dtype == "f32" for n in mm)
    outer = next(n for n in degenerate if n.attrs["mm_dims"] == (1024, 192, 1))
    assert outer.attrs["batch"] == 1024
    assert P.node_key(outer, "h100_sxm") == "h100_sxm|matmul|1024,192,1|f32|b1024"
    assert P.synthesize_and_measure(outer, device="cpu") > 0
    fold = next(n for n in mm if n.attrs["mm_dims"] == (1024, 256, 192))
    assert not P.degenerate_batched(fold) and not P.node_key(fold, "h100_sxm").endswith("|b4")
