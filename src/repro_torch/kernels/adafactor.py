"""Adafactor's update of one layer group: wrapper, plain version, plan, launch
count.

Not the port of a TPU kernel: the reference's Adafactor is array code that
XLA fuses into a few passes over each stacked leaf, and eager PyTorch would
run it as some forty fp32 launches a leaf after stacking the group's layers
into one tensor.  The kernels (``csrc/adafactor.cu``) take the layers where
they lie and read g twice (statistics, apply) and p twice: the update's sum
of squares comes out of the statistics pass in factored form, and a third
pass over g runs only where a guard finds that a clamp could bite on a
nonzero gradient.  Their sums run in fixed orders, so two runs give the same
bits, but in other orders than PyTorch's, so they equal
:func:`adafactor_update_plain` to rounding, not bit for bit.  For a CUDA
tensor the wrapper launches them or raises; only a tensor on the CPU takes
the plain version.

A group is what the reference holds as one array: a block parameter's
tensors of every layer of one position of the block cycle (stacked: the
array is ``(L, *shape)``), or one tensor (the array is the tensor).  Its
state is the reference's: ``{"vr", "vc"}`` where the array is factored (its
last two dims both above 1), else ``{"v"}``; it says which of the two forms
the group takes.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

THREADS = 256            # threads a block of every walk but af_rows_kernel's
ROWS_THREADS = 512       # AF_ROWS_THREADS in the source: af_rows_kernel's block, one an SM
MAX_KC = 4               # AF_MAX_KC: column vectors a thread of af_rows_kernel at most
MAX_STAGES = 8           # stages of af_rows_kernel's ring the plan takes at most
MIN_TILE_BYTES = 32 * 1024   # a smaller tile of g and p: the wide walk (a tile's fixed cost)
BLOCKS_PER_SM = 8        # the most blocks a grid of (b), (c) or the flat walk is given, a SM
SLABS_PER_SM = 4         # the slabs a SM the walks of (b) and (c) aim at
MIN_SLAB_ROWS = 16
MAX_SLAB_ROWS = 1024     # AF_MAX_SLAB in the source: the wide walk's, (b)'s and (c)'s
MAX_TILE_ROWS = 256      # AF_MAX_TILE in the source
MAX_COLUMN_PARTIALS = 16 * 2**20 // 4   # floats of the column workspace the plan aims under
MAX_LAYERS = 128         # AF_MAX_LAYERS in the source
ITEM_COLUMNS = 32        # columns an item of the statistics' column sums
# shared memory af_rows_kernel may take (the H100's 227 KB a block, less room
# for the static part)
ROWS_SMEM = 232448 - 1024
_SMS: dict[int, int] = {}


def factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def group_shape(group_p, state) -> tuple[tuple, bool]:
    """(the reference's array shape of the group, whether it stacks the
    layers), read from the state's shapes."""
    shape = ((*state["vr"].shape, state["vc"].shape[-1]) if "vr" in state
             else tuple(state["v"].shape))
    one = tuple(group_p[0].shape)
    if len(group_p) == 1 and shape == one:
        return shape, False
    if shape == (len(group_p), *one):
        return shape, True
    raise ValueError(f"adafactor: a state of shape {shape} does not fit {len(group_p)} "
                     f"layers of {one}")


@torch.no_grad()
def _upd(g, s, p, *, lr, beta2, eps1, eps2, clip_threshold, weight_decay):
    # the reference's arithmetic, with each full-size fp32 temporary
    # reused in place and dropped once read: at most three such
    # copies of a leaf live at once (recurrentgemma's tied embedding
    # is 4.2 GB a copy), where the expression form holds six
    g = g.to(torch.float32)
    g2 = torch.square(g).add_(eps1)
    if factored(g.shape):
        vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(-1)
        vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(-2)
        del g2
        denom = (vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps1))[..., None] \
            * vc[..., None, :]
        u = denom.clamp_(min=eps1).rsqrt_().mul_(g)      # g * rsqrt(max(denom, eps1))
        new_s = {"vr": vr, "vc": vc}
    else:
        v = beta2 * s["v"] + (1 - beta2) * g2
        del g2
        u = g * torch.rsqrt(torch.clamp(v, min=eps1))
        new_s = {"v": v}
    del g
    rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps1)
    u.div_(torch.clamp(rms_u / clip_threshold, min=1.0))
    pf = p.to(torch.float32, copy=True)
    scale = torch.clamp(torch.sqrt(torch.mean(torch.square(pf))), min=eps2)
    decay = lr * weight_decay * pf
    new_p = pf.sub_(u.mul_(lr * scale)).sub_(decay)   # pf - lr scale u - lr wd pf
    return new_p.to(p.dtype), new_s


@torch.no_grad()
def adafactor_update_plain(group_g, group_p, state, *, lr, beta2, eps1: float, eps2: float,
                           clip_threshold: float, weight_decay: float) -> None:
    """The update in plain torch, in place: the group's layers stacked (or
    its one tensor), the reference's Adafactor step on that array
    (``vr``/``vc`` or ``v`` of ``state`` and the parameters), the result
    copied back into ``group_p`` and ``state``.  ``lr``, ``beta2``: 0-d
    fp32 tensors."""
    _, stacked = group_shape(group_p, state)
    g = torch.stack(list(group_g)) if stacked else group_g[0]
    p = torch.stack(list(group_p)) if stacked else group_p[0]
    new_p, new_s = _upd(g, state, p, lr=lr, beta2=beta2, eps1=eps1, eps2=eps2,
                        clip_threshold=clip_threshold, weight_decay=weight_decay)
    for k, v in new_s.items():
        state[k].copy_(v)
    if stacked:
        for i, t in enumerate(group_p):
            t.copy_(new_p[i])
    else:
        group_p[0].copy_(new_p)


def slab_rows(M: int, R: int, C: int | None, sms: int) -> int:
    """Rows a slab of the wide walk (C given: it keeps column partials of C
    floats a slab under MAX_COLUMN_PARTIALS) or of (b) and (c) (C None): a
    multiple of 8 from MIN_SLAB_ROWS to MAX_SLAB_ROWS, the matrices cut into
    about SLABS_PER_SM slabs a SM; R where a matrix has no more than
    MIN_SLAB_ROWS rows."""
    if R <= MIN_SLAB_ROWS:
        return R
    per_matrix = SLABS_PER_SM * sms // M
    if C is not None:
        per_matrix = min(per_matrix, MAX_COLUMN_PARTIALS // (M * C))
    sr = -(-R // max(1, per_matrix))
    return min(R, MAX_SLAB_ROWS, max(MIN_SLAB_ROWS, -(-sr // 8) * 8))


def rows_columns(C: int, vec: int) -> tuple[int, int]:
    """(lanes, column vectors a thread) of af_rows_kernel: LANES threads
    across the C / vec column vectors (a power of two up to ROWS_THREADS;
    ROWS_THREADS / LANES row groups), each taking every LANES-th."""
    cv = C // vec
    lanes = min(ROWS_THREADS, 1 << max(0, (cv - 1).bit_length()))
    return lanes, -(-cv // lanes)


def rows_smem(tile_rows: int, stages: int, C: int, sg: int, sp: int, lanes: int,
              vec: int) -> int:
    """Bytes of shared memory af_rows_kernel takes (``rows_smem`` in the
    source): the stages (a tile's rows of g, of p, and their vr, each part
    padded to 16 bytes), the row groups' column sums at a slab's end (where
    there is more than one), a tile's row values, the reductions' room and
    the stages' barriers."""
    groups = lanes < ROWS_THREADS
    stage = sum(-(-nbytes // 16) * 16 for nbytes in (
        tile_rows * C * sg, tile_rows * C * sp, tile_rows * 4))
    floats = 2 * ROWS_THREADS * vec * groups + 2 * max(tile_rows, ROWS_THREADS // 32) \
        + tile_rows + 96
    return stages * stage + 4 * floats + 8 + 8 * stages


def _tile_rows_up(rows: int) -> int:
    """The least tile size of at least ``rows`` rows: a divisor of the block's
    16 warps (the row pass gives a row 16 / TR of them) or a multiple of 16."""
    nw = ROWS_THREADS // 32
    return next((t for t in (1, 2, 4, 8) if rows <= t and t < nw), -(-rows // nw) * nw)


def _tile_rows_down(rows: int) -> int:
    nw = ROWS_THREADS // 32
    return rows // nw * nw if rows >= nw else next(t for t in (8, 4, 2, 1) if rows >= t)


def rows_plan(M: int, R: int, C: int, sg: int, sp: int, vec: int, sms: int) -> dict | None:
    """af_rows_kernel's walk of M matrices of R x C (g and p of sg and sp
    bytes an element), or None where a thread would take more than MAX_KC
    column vectors, two stages of one row do not fit, or a tile would hold
    under MIN_TILE_BYTES (many small matrices; the wide walk then).
    One block an SM; about one slab a block (the column workspace, M x S x C
    x 2 floats, under MAX_COLUMN_PARTIALS); tiles of as many rows as fit
    two stages (1, 2, 4, 8 or a multiple of 16, at most MAX_TILE_ROWS, no
    more than a slab needs), then as many stages as fit, up to MAX_STAGES.
    The tile's size sets the kernel's speed more than the stages' count: a
    tile costs a fixed time whatever its bytes."""
    lanes, kc = rows_columns(C, vec)
    if kc > MAX_KC:
        return None

    S = min(max(1, sms // M), max(1, MAX_COLUMN_PARTIALS // (2 * M * C)))
    sr = -(-R // S)
    sr = R if R <= MIN_SLAB_ROWS else min(R, max(MIN_SLAB_ROWS, -(-sr // 8) * 8))
    S = -(-R // sr)

    def fits(tr, st):
        return rows_smem(tr, st, C, sg, sp, lanes, vec) <= ROWS_SMEM
    if not fits(1, 2):
        return None
    fit = 1
    while fit < MAX_TILE_ROWS and fits(fit + 1, 2):
        fit += 1
    tr = min(_tile_rows_down(fit), _tile_rows_up(sr))
    if min(tr, sr) * C * (sg + sp) < MIN_TILE_BYTES:
        return None
    st = 2
    while st < MAX_STAGES and fits(tr, st + 1):
        st += 1
    return {"slab_rows": sr, "slabs_a_matrix": S, "grid": max(1, min(M * S, sms)),
            "blocks_a_sm": 1, "tile_rows": tr, "stages": st, "lanes": lanes, "kc": kc,
            "warps_a_row": 1 if tr >= ROWS_THREADS // 32 else ROWS_THREADS // 32 // tr,
            "smem": rows_smem(tr, st, C, sg, sp, lanes, vec)}


@functools.lru_cache(maxsize=1024)
def launch_plan(shape, layers: int, g_dtype, p_dtype, aligned: int, sms: int,
                bulk: bool = True) -> dict:
    """The kernels' walk of a group whose array has ``shape`` (``layers``
    layers of equal size): ``aligned`` is the largest of 8, 4 and 1 elements
    that every layer's g and p base is aligned to (8 counts only where both
    are bf16 and 16 bytes aligned), ``bulk`` whether every base is 16 bytes
    aligned.  Returns the path (``"plain"``; ``"rows"``; or ``"wide"`` where
    TMA cannot take the rows, a base or a row not 16-byte aligned, or
    ``rows_plan`` finds none), the vector width, the grid, the kernels a
    call launches and the workspace in floats; factored: also M, R, C, the
    statistics' walk (rows a slab, slabs a matrix; rows: tiles, stages,
    column lanes, shared memory) and that of the update's passes
    (``slab_rows2``, ``slabs_a_matrix2``, ``grid2``)."""
    N = math.prod(shape)
    n = N // layers
    if factored(shape):
        R, C = shape[-2], shape[-1]
        M = N // (R * C)
        vec = next(v for v in (8, 4, 1) if v <= aligned and C % v == 0
                   and (v < 8 or g_dtype == p_dtype == torch.bfloat16))
        sg, sp = torch.finfo(g_dtype).bits // 8, torch.finfo(p_dtype).bits // 8
        sr2 = slab_rows(M, R, None, sms)
        S2 = -(-R // sr2)
        cap = sms * BLOCKS_PER_SM
        plan = {"factored": True, "vec": vec, "M": M, "R": R, "C": C, "n": n,
                "slab_rows2": sr2, "slabs_a_matrix2": S2, "grid2": max(1, min(M * S2, cap)),
                "kernels": 3}
        tma = bulk and C * sg % 16 == 0 and C * sp % 16 == 0
        rows = rows_plan(M, R, C, sg, sp, vec, sms) if tma else None
        if rows is not None:
            S = rows["slabs_a_matrix"]
            nu = M * -(-C // ITEM_COLUMNS) if S > 1 else M
            ws = 4 + M + M * S + 2 * nu + M * S2 + ((2 * M * S + 2 * M * S * C) if S > 1 else 0)
            return plan | rows | {"path": "rows", "workspace": ws}
        sr = slab_rows(M, R, C, sms)
        S = -(-R // sr)
        ws = 4 + M + M * S + M * S2 + ((M * S + M * S * C) if S > 1 else 0)
        return plan | {"path": "wide", "slab_rows": sr, "slabs_a_matrix": S,
                       "grid": max(1, min(M * S, cap)), "workspace": ws}
    vec = 4 if aligned >= 4 and n % 4 == 0 else 1
    grid = max(1, min(-(-N // (vec * THREADS)), sms * BLOCKS_PER_SM))
    return {"factored": False, "path": "plain", "vec": vec, "n": n, "grid": grid, "kernels": 2,
            "workspace": 4 + 2 * grid}


def sms_of(device: torch.device) -> int:
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def _alignment(ts) -> int:
    """The largest of 8, 4, 1 elements that every tensor's base is aligned to
    (8 where each base is 16 bytes aligned and the tensors are bf16)."""
    if all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0 for t in ts):
        return 8
    if all(t.data_ptr() % (4 * t.element_size()) == 0 for t in ts):
        return 4
    return 1


def group_plan(group_g, group_p, state, sms: int) -> dict:
    """``launch_plan`` for a group as the wrapper sees it."""
    shape, _ = group_shape(group_p, state)
    ts = [*group_g, *group_p]
    return launch_plan(tuple(shape), len(group_p), group_g[0].dtype, group_p[0].dtype,
                       _alignment(ts), sms, all(t.data_ptr() % 16 == 0 for t in ts))


PATHS = {"plain": 0, "rows": 1, "wide": 2}   # AfPath in the source
GUARD = 3   # the workspace's float that reads 1 where the statistics' sum of u^2 stood
_counters: dict[int, torch.Tensor] = {}


def counters(device: torch.device) -> torch.Tensor:
    """The kernels' four block counters on ``device`` (a grid-wide barrier's
    and three last-block tickets), kept a device: they start at 0 and every
    launch leaves them at 0, so calls on one device must run on one stream."""
    t = _counters.get(device.index)
    if t is None:
        t = _counters[device.index] = torch.zeros(4, dtype=torch.int32, device=device)
    return t


def _lib():
    lib = _build.load("adafactor")
    if lib.adafactor_launch.argtypes is None:
        vp, ci, ll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.adafactor_launch.argtypes = [vp, vp, ci] + [ll] * 4 + [ci] * 15 + [vp] * 6 \
            + [cf] * 4 + [vp]
        lib.adafactor_launch.restype = ci
    return lib


@torch.no_grad()
def adafactor_update(group_g, group_p, state, *, lr, beta2, eps1: float, eps2: float,
                     clip_threshold: float, weight_decay: float) -> torch.Tensor | None:
    """:func:`adafactor_update_plain` by the kernels for CUDA tensors, the
    layers read and written where they lie.  g, p: the group's layers, each
    contiguous, all of one shape, p of one dtype (fp32 or bf16) and g of
    p's or fp32; state: fp32, contiguous, on their device; lr, beta2: 0-d fp32
    tensors there.  Returns the kernels' workspace (``launch_group``), None
    where nothing launched."""
    p0 = group_p[0]
    if p0.device.type == "cpu":
        return adafactor_update_plain(group_g, group_p, state, lr=lr, beta2=beta2, eps1=eps1,
                                      eps2=eps2, clip_threshold=clip_threshold,
                                      weight_decay=weight_decay)
    if p0.device.type != "cuda":
        raise RuntimeError(f"adafactor_update: no kernel for device {p0.device}")
    g0 = group_g[0]
    _build.dtype_code(p0, "adafactor_update p")
    _build.dtype_code(g0, "adafactor_update g")
    if g0.dtype != p0.dtype and g0.dtype != torch.float32:
        raise ValueError(f"adafactor_update: no kernel for {g0.dtype} g with {p0.dtype} p "
                         "(g takes p's dtype or float32)")
    L = len(group_p)
    if len(group_g) != L or not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"adafactor_update: {len(group_g)} gradients for {L} layers "
                         f"(at most {MAX_LAYERS})")
    st = [state[k] for k in ("vr", "vc", "v") if k in state]
    for name, t in [("g", g) for g in group_g] + [("p", p) for p in group_p] \
            + [("state", t) for t in st] + [("lr", lr), ("beta2", beta2)]:
        if t.device != p0.device:
            raise ValueError(f"adafactor_update: {name} is on {t.device}, p on {p0.device}")
    if any(g.dtype != g0.dtype or g.shape != p0.shape for g in group_g) \
            or any(p.dtype != p0.dtype or p.shape != p0.shape for p in group_p):
        raise ValueError("adafactor_update: the group's layers must share one shape and dtype")
    if any(t.dtype != torch.float32 for t in st) or not all(t.is_contiguous() for t in st):
        raise ValueError("adafactor_update: the state must be float32 and contiguous")
    if any(t.dtype != torch.float32 or t.numel() != 1 for t in (lr, beta2)):
        raise ValueError("adafactor_update: lr and beta2 must be one float32 each")
    if not all(t.is_contiguous() for t in (*group_g, *group_p)):
        raise ValueError("adafactor_update: g and p must be contiguous")
    if any(t.data_ptr() % 16 for t in st):
        raise ValueError("adafactor_update: the state must be 16-byte aligned")
    if p0.numel() == 0:
        return None
    return launch_group(group_g, group_p, state, group_plan(group_g, group_p, state, sms_of(p0.device)),
                 lr=lr, beta2=beta2, eps1=eps1, eps2=eps2, clip_threshold=clip_threshold,
                 weight_decay=weight_decay)


def launch_group(group_g, group_p, state, plan, *, lr, beta2, eps1, eps2, clip_threshold,
                 weight_decay) -> torch.Tensor:
    """The kernels of one group on ``plan`` (``group_plan``'s, or another
    walk of the same group to time against it), the arguments as
    :func:`adafactor_update` has checked them.  Returns the workspace (its
    float ``GUARD`` says, once the kernels have run, whether the update's
    sum of squares came from the statistics pass)."""
    p0 = group_p[0]
    L = len(group_p)
    ws = torch.empty(plan["workspace"], dtype=torch.float32, device=p0.device)
    gp = (ctypes.c_void_p * L)(*[t.data_ptr() for t in group_g])
    pp = (ctypes.c_void_p * L)(*[t.data_ptr() for t in group_p])
    f = plan["factored"]
    v, vc = (state["vr"], state["vc"]) if f else (state["v"], None)
    _build.launch(_lib().adafactor_launch, p0.device, "adafactor", gp, pp, L, plan["n"],
                  plan.get("M", 0), plan.get("R", 0), plan.get("C", 0), PATHS[plan["path"]],
                  plan.get("slab_rows", 0), plan.get("slabs_a_matrix", 0), plan["grid"],
                  plan.get("slab_rows2", 0), plan.get("slabs_a_matrix2", 0),
                  plan.get("grid2", 0), plan["vec"], plan.get("tile_rows", 0),
                  plan.get("stages", 0), plan.get("lanes", 0), plan.get("kc", 0), sms_of(p0.device),
                  _build.dtype_code(p0, "adafactor p"), _build.dtype_code(group_g[0], "adafactor g"),
                  v.data_ptr(), vc.data_ptr() if vc is not None else None, ws.data_ptr(),
                  counters(p0.device).data_ptr(), lr.data_ptr(), beta2.data_ptr(), eps1, eps2,
                  clip_threshold, weight_decay)
    adafactor_update.launches += plan["kernels"]
    return ws


adafactor_update.launches = 0   # kernel launches made by this wrapper (2 or 3 a group)
