"""What the kernel wrappers decide on the host, as plain functions: K2's
split plan, K1's tiles and shared memory, the 16-byte operand rule of K1's
TMA path, and K3's launch plan.  The compiled kernels report the same plans
on the card (``chip_smoke.py`` holds the two against each other)."""
import importlib

import pytest
import torch

# the package's names of the two wrappers hide their modules: fetch the modules
dec = importlib.import_module("repro_torch.kernels.decode_attention")
fa = importlib.import_module("repro_torch.kernels.flash_attention")
rms = importlib.import_module("repro_torch.kernels.rmsnorm")


@pytest.mark.parametrize("B,Hkv,T,blocks_per_sm", [
    (8, 8, 2048, 5),     # phi4-mini serving: 8 slots, ring cache of 2048
    (8, 8, 2048, 2),
    (1, 8, 1000, 4),
    (4, 8, 1500, 3),     # qwen2.5-32b's 8 kv heads
    (2, 8, 16384, 5),    # a long cache: many splits
    (1, 16, 300, 4),     # gemma-7b, G = 1
    (32, 8, 2048, 5),    # more (b, kv head) pairs than resident blocks: one split
    (1, 1, 1, 4),
    (2, 2, 33, 16),
    (1, 1, 2048, 2),     # the long_500k cell's decode: one sequence, one kv head of 16 q heads
    (8, 1, 2048, 2),     # recurrentgemma's serving decode on the tensor-core kernel
    (8, 4, 2048, 3),     # qwen2-vl's
    (1, 4, 2048, 3),     # qwen2-vl's at one sequence
    (1, 1, 524288, 2),   # a cache past MAX_SPLITS floors
])
@pytest.mark.parametrize("rows", [8, 32, 64])
def test_split_plan_covers_the_cache_in_one_wave(B, Hkv, T, blocks_per_sm, rows):
    ns, chunk = dec.split_plan(B, Hkv, T, sm_count=132, blocks_per_sm=blocks_per_sm,
                               rows_per_iter=rows)
    assert ns >= 1 and (ns - 1) * chunk < T <= ns * chunk          # covers, no empty split
    assert chunk % rows == 0                                       # whole iterations
    slots = 132 * blocks_per_sm
    assert B * Hkv * ns <= max(slots, B * Hkv)                     # one wave at most,
    assert ns == 1 or chunk >= dec.SPLIT_FLOOR                     # no split under the floor,
    assert ns <= dec.MAX_SPLITS
    want = max(1, min(slots // (B * Hkv), T // dec.SPLIT_FLOOR, dec.MAX_SPLITS,
                      -(-T // rows)))                              # and as many splits as fill
    assert chunk - rows < T / want <= chunk                        # it, up to the rounding of chunks


@pytest.mark.parametrize("T", [1, 127, 128, 129, 300, 448, 1500, 2047, 2048, 9000, 16384])
@pytest.mark.parametrize("pairs,blocks_per_sm", [(1, 2), (1, 5), (3, 2), (8, 3), (64, 2)])
def test_split_plan_floor_and_no_empty_split(T, pairs, blocks_per_sm):
    """The floor: a split under ``SPLIT_FLOOR`` rows only where the cache is
    one split; every split holds a row of the cache (so every block of the
    launch reads); each kernel's rows."""
    for rows in (16, 32, 64):
        ns, chunk = dec.split_plan(pairs, 1, T, sm_count=132, blocks_per_sm=blocks_per_sm,
                                   rows_per_iter=rows)
        assert (ns - 1) * chunk < T <= ns * chunk
        assert ns == 1 or chunk >= dec.SPLIT_FLOOR
        assert ns <= min(dec.MAX_SPLITS, max(1, 132 * blocks_per_sm // pairs))


def test_split_plan_at_one_sequence_takes_the_floor():
    # recurrentgemma's long_500k decode (B1, one kv head, T 2048, two blocks an SM):
    # filling the card gave 128 splits of 16 rows; the floor gives 16 of 128
    assert dec.split_plan(1, 1, 2048, sm_count=132, blocks_per_sm=2, rows_per_iter=32) == (16, 128)
    # recurrentgemma's B8 serving decode: 16 splits of 128 rows, 128 blocks
    assert dec.split_plan(8, 1, 2048, sm_count=132, blocks_per_sm=2, rows_per_iter=32) == (16, 128)
    # qwen2-vl's B8 serving decode (4 kv heads, three blocks an SM): the card fills first,
    # 12 splits' worth that whole stages of 32 rows round to 11 of 192
    assert dec.split_plan(8, 4, 2048, sm_count=132, blocks_per_sm=3, rows_per_iter=32) == (11, 192)
    # a forced count stays under MAX_SPLITS and one split a row group
    assert dec.split_plan(1, 1, 1 << 20, n_splits=10 ** 4, rows_per_iter=32)[0] == dec.MAX_SPLITS
    assert dec.split_plan(1, 1, 64, n_splits=8, rows_per_iter=32) == (2, 32)


@pytest.mark.parametrize("G", [1, 2, 3, 5, 7, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_path_heads_and_rows_by_group_and_dtype(G, dtype):
    """bf16 at a group of 5, 7, 8 or 16 takes the tensor-core kernel: the
    whole group in a block (16 heads at G 16), splits in ring stages of 32
    rows at every head dim.  fp32, and bf16 at a group of 1-3, take the
    CUDA-core kernel, an fp32 group of 16 as two blocks of 8."""
    tc = dtype == torch.bfloat16 and G in (5, 7, 8, 16)
    assert dec.kernel_path(G, dtype) == ("tensor_cores" if tc else "cuda_cores")
    assert dec.heads_a_block(G, dtype) == (8 if G == 16 and not tc else G)
    assert dec.head_blocks(4, G, dtype) == (8 if G == 16 and not tc else 4)
    item = torch.tensor([], dtype=dtype).element_size()
    for D in dec.SUPPORTED_D:
        want = dec.STAGE_ROWS if tc else dec.rows_per_iter(D, item)
        assert dec.plan_rows(G, D, dtype) == want


def test_rows_per_iter_follows_the_16_byte_loads():
    # bf16: 16 lanes a row at D = 128, so 2 rows a load, 4 loads a lane, 4 warps
    assert dec.rows_per_iter(128, 2) == 32
    assert dec.rows_per_iter(64, 2) == 64
    assert dec.rows_per_iter(256, 2) == 16
    assert dec.rows_per_iter(64, 4) == 32
    assert dec.rows_per_iter(128, 4) == 16
    assert dec.rows_per_iter(256, 4) == 8      # two loads a row: 2 rows a lane


def test_decode_raises_for_a_group_size_without_a_kernel():
    q = torch.ones((1, 4, 64), device="meta")
    k = torch.ones((1, 1, 8, 64), device="meta")
    assert 4 not in dec.SUPPORTED_G
    with pytest.raises(RuntimeError):     # meta: no kernel for the device at all
        dec.decode_attention(q, k, k)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_tile_plan_fits_shared_memory(D):
    plan = fa.tile_plan(D)
    assert plan["smem_bytes"] <= fa.SMEM_LIMIT
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= fa.SM_SMEM
    # one 64-row block an SM at D 256; three at D 64, whose producer is a warp (160 threads)
    # and whose kv tiles are 128 rows in a ring of two stages; at D 128 one block of two
    # consumer warpgroups (128 q rows) and a producer warpgroup (384 threads) and a ring of
    # three stages of 128 kv rows
    assert plan["blocks_per_sm"] == {64: 3, 128: 1, 256: 1}[D]
    assert plan["q_rows"] == (128 if D == 128 else 64) and plan["stages"] >= 2
    assert (plan["threads"], plan["kv_rows"]) == ((160, 128) if D == 64 else
                                                  (384, 128) if D == 128 else (256, 64))
    tiles = plan["q_rows"] * D * 2 + 2 * plan["stages"] * plan["kv_rows"] * D * 2
    assert tiles + 256 == plan["smem_bytes"]
    # one block an SM at D 128 and D 256: its grid goes heaviest q tile first over every head
    assert plan["flat_grid"] == (D in (128, 256))


@pytest.mark.parametrize("S", [1, 333, 1000, fa.PAIR_MIN_KEYS - 1])
def test_flash_tile_plan_at_d128_below_the_two_consumer_rows(S):
    """Below PAIR_MIN_KEYS rows D 128 keeps one consumer warpgroup of 64 q
    rows on 64-row kv tiles, a ring of three stages, two blocks an SM, on
    the flat grid; from it the block of two consumer warpgroups."""
    assert fa.tile_plan(128, None, S) == {"q_rows": 64, "kv_rows": 64, "stages": 3,
                                          "threads": 256, "blocks_per_sm": 2,
                                          "smem_bytes": 114_944, "flat_grid": 1}
    assert fa.tile_plan(128, None, fa.PAIR_MIN_KEYS) == fa.tile_plan(128) == fa.tile_plan(128, 128)
    assert fa.tile_plan(256, None, S) == fa.tile_plan(256)     # the other widths take no S


@pytest.mark.parametrize("D", [32, 96, 512])
def test_flash_tile_plan_rejects_what_the_kernel_lacks(D):
    with pytest.raises(ValueError):
        fa.tile_plan(D)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [3072, 5120, 7168, 64, 100, 256, 16384])   # the four configs' widths, edges
def test_rmsnorm_launch_plan_covers_the_row_in_whole_vectors(D, dtype, aligned):
    threads, chunks, vector = rms.launch_plan(D, dtype, aligned=aligned)
    itemsize = dtype.itemsize
    whole = 16 // itemsize
    assert vector == (whole if aligned and D % whole == 0 else 1)    # 16-byte loads where they fit
    assert D % vector == 0
    assert threads % 32 == 0 and 32 <= threads <= rms.MAX_THREADS <= 1024
    assert chunks in (rms.VECTOR_CHUNKS if vector > 1 else rms.SCALAR_CHUNKS)
    n = D // vector
    assert (threads - 32) * chunks < n <= threads * chunks           # covers the row, no idle warp
    fewer = [c for c in (rms.VECTOR_CHUNKS if vector > 1 else rms.SCALAR_CHUNKS) if c < chunks]
    assert all(-(-n // c) > rms.MAX_THREADS for c in fewer)          # the fewest chunks that fit


def test_rmsnorm_plan_at_the_serving_shapes_and_its_limit():
    assert rms.launch_plan(3072, torch.bfloat16) == (384, 1, 8)     # a 6 KB row in flight at once
    assert rms.launch_plan(3072, torch.float32) == (384, 2, 4)
    assert rms.launch_plan(3072, torch.bfloat16, aligned=False) == (384, 8, 1)
    for dtype in (torch.bfloat16, torch.float32):
        for aligned in (True, False):
            rms.launch_plan(rms.MAX_D, dtype, aligned=aligned)       # every variant holds MAX_D
    with pytest.raises(ValueError, match="registers"):
        rms.launch_plan(16385, torch.bfloat16)                      # scalar: 32 chunks x 512 threads
    x, w = torch.ones((2, rms.MAX_D + 8), dtype=torch.bfloat16), torch.ones(rms.MAX_D + 8)
    with pytest.raises(ValueError, match="limit"):                  # checked before any launch
        rms._launch(x, w, None, eps=1e-6, offset=0, with_sum=False)


def test_operand_check_wants_16_byte_strides():
    base = torch.zeros((2, 300, 8, 128), dtype=torch.bfloat16)
    fa.check_operand("q", base.permute(0, 2, 1, 3))                 # the model's layout: fine
    fa.check_operand("q", base[:, :, :, :64].permute(0, 2, 1, 3))   # 128-byte rows of a wider one
    odd = torch.zeros((2, 300, 8, 132), dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="16 bytes"):                # 264-byte head stride
        fa.check_operand("q", odd.permute(0, 2, 1, 3))
    f32 = torch.zeros((1, 4, 50, 66), dtype=torch.float32)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):                # 264-byte rows
        fa.check_operand("k", f32)
    with pytest.raises(ValueError, match="stride 1"):
        fa.check_operand("k", torch.zeros((1, 2, 64, 8)).transpose(2, 3))
    shifted = torch.zeros(8 * 64 * 64 + 4, dtype=torch.bfloat16)[4:].view(1, 8, 64, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):         # base 8 bytes off
        fa.check_operand("v", shifted)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_tile_plan_fits_shared_memory_and_registers(D):
    plan = fa.bwd_tile_plan(D)
    assert plan["q_rows"] == plan["kv_rows"] == 64 and plan["stages"] >= 2   # wgmma's m64 tiles
    assert plan["dkdv_threads"] == plan["dq_threads"] == 128               # one warpgroup
    assert plan["dq_blocks_per_sm"] == 2
    assert plan["dkdv_blocks_per_sm"] == (3 if D == 64 else 2)   # D 64: a third warpgroup an SM
    for kernel in ("dkdv", "dq"):
        assert plan[f"smem_{kernel}"] <= fa.SMEM_LIMIT
        assert plan[f"{kernel}_blocks_per_sm"] * (plan[f"smem_{kernel}"] + 1024) <= fa.SM_SMEM
    tile = 64 * D * 2
    staged = 64 * 64 * 4 if D == 64 else 0      # P^T in fp32 while dP^T is formed (D 64)
    assert plan["smem_dkdv"] == ((2 + 2 * plan["stages"]) * tile + staged
                                 + 2 * plan["stages"] * 256 + 64)
    assert plan["smem_dq"] == (2 + 2 * plan["stages"]) * tile + 64
    # registers: a thread of the dK/dV warpgroup holds dK and dV of its 2 rows x D/4 columns
    # and P^T, dS^T as bf16 pairs (16 each), and S^T and dP^T (32 each) at once, or at D 64 one
    # of them at a time.  Two blocks an SM leave it 255, three (D 64) 168 (65536 over 384
    # threads, in units of 8)
    cap = min(255, 65536 // (plan["dkdv_threads"] * plan["dkdv_blocks_per_sm"]) // 8 * 8)
    need = 2 * (D // 2) + (1 if D == 64 else 2) * 32 + 2 * 16
    assert cap == (168 if D == 64 else 255) and need <= cap - 15


@pytest.mark.parametrize("D", [32, 96, 160, 512])
def test_flash_bwd_tile_plan_rejects_what_the_tensor_cores_lack(D):
    with pytest.raises(ValueError):
        fa.bwd_tile_plan(D)


@pytest.mark.parametrize("dims", [(256, 256), (192, 128)])
def test_flash_bwd_split_plan_fits_shared_memory_and_registers(dims):
    """Above a head dim of 128 the dK/dV block is two warpgroups (one owns dV
    and P^T, the other dK and dS^T), one block an SM; the dQ block one
    warpgroup, one block an SM at D 256 and, with a ring of one stage, two
    at (192, 128).  Shared memory: K and V, two ring stages of Q and dO with
    their lse and delta rows, the 16 KB of P^T handed between the
    warpgroups; registers under a thread's 255 less a margin."""
    D, Dv = dims
    plan = fa.bwd_tile_plan(D, Dv)
    assert plan["q_rows"] == plan["kv_rows"] == 64 and plan["stages"] == 2
    assert (plan["dkdv_threads"], plan["dkdv_blocks_per_sm"]) == (256, 1)
    assert (plan["dq_threads"], plan["dq_stages"], plan["dq_blocks_per_sm"]) == \
        ((128, 2, 1) if D == Dv else (128, 1, 2))
    for kernel in ("dkdv", "dq"):
        assert plan[f"smem_{kernel}"] <= fa.SMEM_LIMIT
        assert plan[f"{kernel}_blocks_per_sm"] * (plan[f"smem_{kernel}"] + 1024) <= fa.SM_SMEM
    assert 2 * (plan["smem_dq"] + 64 * (D + Dv) * 2 + 1024) > fa.SM_SMEM   # two blocks of two
    tile = 64 * (D + Dv) * 2                                             # stages do not fit
    assert plan["smem_dkdv"] == 3 * tile + 64 * 64 * 4 + 2 * 2 * 256 + 64
    assert plan["smem_dq"] == (1 + plan["dq_stages"]) * tile + 64
    if dims == (256, 256):     # the sizes reckoned for recurrentgemma's and gemma-7b's D
        assert (plan["smem_dkdv"], plan["smem_dq"]) == (214_080, 196_672)
    # registers: a dK/dV warpgroup holds one gradient of its 2 rows x D/4 columns (dV or dK),
    # S^T or dP^T (32) and its bf16 half (16); the dQ warpgroup dQ, S and dP, dS's half
    for threads, blocks, regs in ((plan["dkdv_threads"], plan["dkdv_blocks_per_sm"],
                                   max(D, Dv) // 2 + 32 + 16),
                                  (plan["dq_threads"], plan["dq_blocks_per_sm"],
                                   D // 2 + 2 * 32 + 16)):
        cap = min(255, 65536 // (threads * blocks))
        assert cap == 255 and regs <= cap - 15


def test_flash_bwd_block_order_at_a_group_of_16():
    """recurrentgemma's MQA (16 q heads on one kv head, S 2048): the dK/dV
    grid has a block a (kv tile, q head), 32 x 16 = 512, where the FMA path's
    (kv tile, kv head) grid had 64; every head's first kv tile leads."""
    order = fa.bwd_block_order("dkdv", 1, 16, 2048)
    assert len(order) == 512 == len(set(order))
    assert order[:16] == [(0, h, 0) for h in range(16)]
    assert fa.bwd_fma_plan(256)["kv_rows"] * 64 == 2048      # the FMA path's 64 blocks
    assert len(fa.bwd_block_order("dq", 1, 16, 2048)) == 512
    assert fa.bwd_block_order("dq", 1, 16, 2048)[0] == (31, 0, 0)


@pytest.mark.parametrize("G", [1, 3, 8])
def test_flash_bwd_workspace_is_what_each_path_needs(G):
    B, Hkv, Sq, Sk, D = 1, 8, 2048, 2048, 128
    H = G * Hkv
    rows = B * H * Sq * 4                                       # Sq a multiple of the tile
    # lse, delta; at D 128 for G > 1 each kv head's running sums of dK and dV and a turn a
    # (kv head, kv tile), which the group's blocks pass on in head order: no q head's partials
    turns = B * Hkv * (Sk // 64) * 4                             # 1 KB: a multiple of 256
    sums = 2 * B * Hkv * Sk * D * 4 + turns if G > 1 else 0
    want = 2 * rows + sums
    assert fa.bwd_workspace_bytes(B, H, Hkv, Sq, Sk, D, torch.bfloat16, True) == want
    if G == 3:
        assert want == 393_216 + 16_777_216 + 1_024              # phi4-mini's train shape
        assert want < 2 * rows + 2 * B * H * Sk * D * 4          # the partials' 50.3 MB
    # the FMA path (fp32, unaligned views) needs delta alone; bf16 aligned D = 256 is the
    # tensor-core path's at its width
    for dtype, aligned, d in ((torch.float32, True, 128), (torch.bfloat16, False, 128),
                              (torch.float32, True, 256), (torch.bfloat16, False, 256)):
        assert fa.bwd_workspace_bytes(B, H, Hkv, Sq, Sk, d, dtype, aligned) == B * H * Sq * 4
    assert fa.bwd_workspace_bytes(B, H, Hkv, Sq, Sk, 256, torch.bfloat16, True) == \
        2 * rows + (2 * B * H * Sk * 256 * 4 if G > 1 else 0)
    ragged = fa.bwd_workspace_bytes(2, 40, 8, 333, 333, 128, torch.bfloat16, True)
    # rows padded to 384; 2 x 8 x 6 turns, 384 bytes padded to 512
    assert ragged == 2 * (2 * 40 * 384 * 4) + 2 * (2 * 8 * 333 * 128 * 4) + 512
    assert all(part % 256 == 0 for part in (2 * 40 * 384 * 4, 2 * 8 * 333 * 128 * 4))
    # a window's or D 64's group keeps the partials a q head
    assert fa.bwd_workspace_bytes(2, 40, 8, 333, 333, 64, torch.bfloat16, True) == \
        2 * (2 * 40 * 384 * 4) + 2 * (2 * 40 * 333 * 64 * 4)


@pytest.mark.parametrize("dims", [(64, 64), (128, 128), (256, 256), (192, 128)])
def test_flash_bwd_fma_plan_fits_shared_memory(dims):
    """The FMA backward's tiles: fp32 rows padded by 4 (a stride of an odd
    number of 16-byte words), 32 kv rows a dK/dV block above a q/k head dim
    of 128, every block within the 227 KB a block may take.  At MLA's (192,
    128) a dK/dV block takes 91 KB (two an SM) and a dQ block 132 KB."""
    D, Dv = dims
    plan = fa.bwd_fma_plan(D, Dv)
    assert plan["kv_rows"] == (64 if D <= 128 else 32)
    assert ((D + 4) // 4) % 2 == 1 and ((Dv + 4) // 4) % 2 == 1
    assert max(plan["smem_dkdv"], plan["smem_dq"]) <= fa.SMEM_LIMIT
    if dims == (192, 128):
        assert plan == {"kv_rows": 32, "smem_dkdv": 93_440, "smem_dq": 135_168}
        assert 2 * (plan["smem_dkdv"] + 1024) <= fa.SM_SMEM
    if dims == (256, 256):     # what the kernels took before MLA's dims
        assert plan == {"kv_rows": 32, "smem_dkdv": 142_592, "smem_dq": 208_896}


@pytest.mark.parametrize("dims", [(192, 192), (128, 192), (128, 64), (96, 96)])
def test_flash_bwd_takes_no_other_pair_of_head_dims(dims):
    with pytest.raises(ValueError):
        fa.bwd_fma_plan(*dims)


def test_flash_bwd_workspace_at_mla_dims_is_the_fma_paths():
    """(192, 128) takes the FMA kernels in fp32 or with views off 16 bytes
    (delta alone), the tensor-core kernels in bf16 with aligned views: delta
    and lse rows, and for G > 1 the partial dK at 192 and dV at 128."""
    rows = 128 * 2048 * 4
    for dtype, aligned in ((torch.float32, True), (torch.float32, False),
                           (torch.bfloat16, False)):
        assert fa.bwd_workspace_bytes(1, 128, 128, 2048, 2048, 192, dtype, aligned,
                                      128) == rows
    assert fa.bwd_workspace_bytes(1, 128, 128, 2048, 2048, 192, torch.bfloat16, True,
                                  128) == 2 * rows                     # G = 1: no partials
    assert fa.bwd_workspace_bytes(2, 16, 4, 333, 333, 192, torch.bfloat16, True, 128) == \
        2 * (2 * 16 * 384 * 4) + 2 * 16 * 333 * (192 + 128) * 4
    # one head dim of 128 named twice is the tensor-core path's
    assert fa.bwd_workspace_bytes(1, 24, 8, 2048, 2048, 128, torch.bfloat16, True, 128) == \
        fa.bwd_workspace_bytes(1, 24, 8, 2048, 2048, 128, torch.bfloat16, True)


@pytest.mark.parametrize("rows", [1, 8, 255, 256, 527, 528, 2048])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [3072, 64, 100, 256, 5120, 16384])
def test_rmsnorm_bwd_plan_covers_the_rows_and_columns(D, dtype, aligned, rows):
    threads, chunks, vector, parts, dw_blocks = rms.bwd_launch_plan(D, dtype, rows,
                                                                    aligned=aligned)
    fwd = rms.launch_plan(D, dtype, aligned=aligned)
    assert vector == fwd[2] and D % vector == 0                          # the forward's loads
    n = D // vector
    assert threads % 32 == 0 and (threads - 32) * chunks < n <= threads * chunks   # covers the row
    small = threads <= rms.BWD_THREADS and chunks <= rms.BWD_CHUNKS
    assert small or (threads, chunks, vector) == fwd                     # else the forward's plan
    if not small:                                                        # ... only where no
        assert -(-n // rms.BWD_CHUNKS) > rms.BWD_THREADS or vector == 1  # small block holds it
    assert parts == max(1, min(rows, rms.BWD_PARTS_SMALL if small else rms.BWD_PARTS))
    assert (dw_blocks - 1) * rms.DW_COLS < D <= dw_blocks * rms.DW_COLS  # the sum covers dw
    if D == 3072 and dtype is torch.bfloat16 and aligned and rows == 2048:
        assert (threads, chunks, vector, parts, dw_blocks) == (128, 3, 8, 528, 192)
