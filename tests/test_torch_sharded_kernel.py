"""Sharded attention through the kernels' path (``strategy="kernel"``).

``layers._sharded_attention`` runs the local case, where k and v keep every
kv row on each rank (batch or kv heads sharded), on each rank's shards under
``local_map``: K1 (prefill) or K2 (decode) on the card, their plain versions
on the CPU.  Two and four gloo ranks on the CPU, in subprocesses, as
``test_torch_moe_ep.py`` starts them, run a prefill (causal, and causal with
a window) and a decode with ragged valid lengths in float32 on DTensors
sharded over batch and over kv heads: ``strategy="kernel"`` must equal
``strategy="dense"`` on the same DTensors within 2e-6, and the kernel call
on the plain tensors.  The reference has no such call (its kernels are not
sharded), so the dense strategy, which is the reference's attention, is the
yardstick.  A KV sequence sharded across ranks, or a q-sequence shard, must
raise with the reason.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TOL = 2e-6   # float32: the plain kernel versions and the dense strategy sum in other orders

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L

rank, port, world, out = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=world)
try:
    rng = np.random.default_rng(0)
    B, S, T, Hkv, G, D = 4, 16, 24, 4, 2, 16
    t = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    q, k, v = t(B, S, Hkv, G, D), t(B, S, Hkv, D), t(B, S, Hkv, D)
    qd, kc, vc = t(B, 1, Hkv, G, D), t(B, T, Hkv, D), t(B, T, Hkv, D)
    valid = torch.tensor([24, 5, 17, 1], dtype=torch.int32)
    if world == 2:
        mesh = make_mesh((2,), ("data",))
        layouts = {"batch": ([Shard(0)], [Shard(0)]), "heads": ([Shard(2)], [Replicate()])}
        kv_seq, q_seq = [Shard(1)], [Shard(1)]
        rep = [Replicate()]
    else:
        mesh = make_mesh((2, 2), ("data", "model"))
        layouts = {"batch_heads": ([Shard(0), Shard(2)], [Shard(0), Replicate()]),
                   "heads": ([Replicate(), Shard(2)], [Replicate(), Replicate()])}
        kv_seq, q_seq = [Shard(1), Replicate()], [Shard(1), Replicate()]
        rep = [Replicate(), Replicate()]
    calls = {
        "prefill": ((q, k, v), dict(causal=True)),
        "prefill_window": ((q, k, v), dict(causal=True, window=6)),
        "decode": ((qd, kc, vc), dict(causal=False, kv_valid_len=valid)),
    }
    res = {}
    for name, (pl, vl_pl) in layouts.items():
        for kind, (args, kw) in calls.items():
            dts = [distribute_tensor(a, mesh, pl) for a in args]
            kw_d = dict(kw)
            if "kv_valid_len" in kw:
                kw_d["kv_valid_len"] = distribute_tensor(kw["kv_valid_len"], mesh, vl_pl)
            with torch.no_grad():
                got = L.attention(*dts, strategy="kernel", **kw_d)
                dense = L.attention(*dts, strategy="dense", **kw_d)
                plain = L.attention(*args, strategy="kernel", **kw)
            res[f"{name}/{kind}"] = {
                "placements_kept": tuple(got.placements) == tuple(dts[0].placements),
                "vs_dense": float((got.full_tensor() - dense.full_tensor()).abs().max()),
                "vs_plain_tensors": float((got.full_tensor() - plain).abs().max()),
                "shape": list(got.shape)}
    raised = {}
    for name, args, pls, kw in (
            ("kv_seq", (qd, kc, vc), (rep, kv_seq, kv_seq),
             dict(causal=False, kv_valid_len=valid)),
            ("q_seq", (q, k, v), (q_seq, rep, rep), dict(causal=True))):
        dts = [distribute_tensor(a, mesh, p) for a, p in zip(args, pls)]
        try:
            L.attention(*dts, strategy="kernel", **kw)
            raised[name] = None
        except NotImplementedError as e:
            raised[name] = str(e)
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump({"results": res, "raised": raised}, f)
    print("RANK_OK", rank)
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def ranks(request, tmp_path_factory):
    world = request.param
    out = str(tmp_path_factory.mktemp(f"sharded_kernel_{world}") / "out")
    port = str(_free_port())
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port, str(world), out],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(REPO)) for r in range(world)]
    outs = [p.communicate(timeout=600) for p in procs]
    for r, (o, e) in enumerate(outs):
        assert f"RANK_OK {r}" in o, o[-2000:] + e[-4000:]
    return world, [json.loads(Path(f"{out}.{r}.json").read_text()) for r in range(world)]


LAYOUTS = {2: ("batch", "heads"), 4: ("batch_heads", "heads")}


@pytest.mark.parametrize("kind", ["prefill", "prefill_window", "decode"])
@pytest.mark.parametrize("layout", [0, 1], ids=["batch", "heads"])
def test_kernel_strategy_on_dtensors_equals_dense(ranks, layout, kind):
    world, per_rank = ranks
    key = f"{LAYOUTS[world][layout]}/{kind}"
    for got in per_rank:
        r = got["results"][key]
        assert r["placements_kept"], key
        assert r["vs_dense"] <= TOL and r["vs_plain_tensors"] <= TOL, (key, r)


def test_kernel_strategy_refuses_a_sharded_kv_sequence(ranks):
    world, per_rank = ranks
    for got in per_rank:
        msg = got["raised"]["kv_seq"]
        assert msg is not None and "KV sequence sharded" in msg and "combine" in msg


def test_kernel_strategy_refuses_a_q_sequence_shard(ranks):
    world, per_rank = ranks
    for got in per_rank:
        msg = got["raised"]["q_seq"]
        assert msg is not None and "q sequence sharded" in msg and "q_offset" in msg
