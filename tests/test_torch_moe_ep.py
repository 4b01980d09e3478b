"""The MoE's expert-parallel path (``layers._moe_expert_parallel``): the
twin of the reference's ``test_system.py::test_moe_sharded_matches_local``.

Four gloo ranks on the CPU, in subprocesses, hold a (2, 2) mesh over
``(data, model)`` and run the tiny olmoe at capacity factor 8 in float32:
parameters and tokens as DTensors placed by ``param_pspecs`` (ZeRO 0) and
``batch_pspecs``, the MoE interior on each rank's shards with two
all-to-alls over the model axis.  Its output must agree within 1e-4 with
the port's single-device forward and with the reference's, and its router
loss within 1e-6 with the reference's sharded forward on the same mesh of
4 host devices (the weights are the reference's, carried over by
``repro_torch.convert``).  The same
forward traced on a fake world of 4 ranks holds exactly two all-to-alls over
the model group in each MoE layer.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
B, S = 4, 16

WORKER = r"""
import sys, numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_tiny_config
from repro_torch.convert import from_reference_params
from repro_torch.distributed.sharding import ShardingEnv, activate
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.training.train_step import batch_pspecs, param_pspecs, to_named

rank, port, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
try:
    cfg = get_tiny_config("olmoe-1b-7b").replace(capacity_factor=8.0, dtype="float32",
                                                 param_dtype="float32")
    z = np.load(data, allow_pickle=True)
    params = from_reference_params(z["params"].item(), cfg, "cpu")
    toks = torch.tensor(z["tokens"])
    model = Model(cfg, "cpu")
    with torch.no_grad():
        local, _ = model.forward(params, {"tokens": toks})      # single-device path
    mesh = make_mesh((2, 2), ("data", "model"))
    env = ShardingEnv(mesh)
    with activate(env):
        p_pl = to_named(env, param_pspecs(cfg, env, 0))

        def place(t, pl):
            if isinstance(t, dict):
                return {k: place(t[k], pl[k]) for k in t}
            if isinstance(t, list):
                return [place(a, b) for a, b in zip(t, pl)]
            return distribute_tensor(t, mesh, list(pl))
        params_s = place(params, p_pl)
        tok_pl = to_named(env, batch_pspecs(cfg, env, B, kind="prefill"))["tokens"]
        toks_s = distribute_tensor(toks, mesh, list(tok_pl))
        with torch.no_grad(), implicit_replication():
            out, aux = model.forward(params_s, {"tokens": toks_s})
        out = out.full_tensor()
        aux = aux.full_tensor() if hasattr(aux, "full_tensor") else aux
    if rank == 0:
        np.savez(data + ".out.npz", sharded=out.numpy(), local=local.numpy(),
                 aux=np.asarray(float(aux)))
    print("RANK_OK", rank)
finally:
    dist.destroy_process_group()
""".replace("B, kind", f"{B}, kind")


# the reference's sharded forward on a (2, 2) mesh of 4 host devices (as
# ``test_system.py::test_moe_sharded_matches_local`` runs it): its logits
# and its router loss, the mean of each model rank's loss (``pmean``)
REF_SHARDED = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_tiny_config
from repro.distributed.sharding import ShardingEnv, activate
from repro.models import Model, init_params
from repro.training.train_step import param_pspecs, to_named

cfg = get_tiny_config("olmoe-1b-7b").replace(capacity_factor=8.0, dtype="float32",
                                             param_dtype="float32")
params = init_params(cfg, jax.random.PRNGKey(0))
toks = np.load(sys.argv[1], allow_pickle=True)["tokens"].astype(np.int32)
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
env = ShardingEnv(mesh)
m = Model(cfg)
with activate(env), mesh:
    params_s = jax.device_put(params, to_named(env, param_pspecs(cfg, env, 0)))
    toks_s = jax.device_put(toks, NamedSharding(mesh, P("data", None)))
    out, aux = jax.jit(lambda p, t: m.forward(p, {"tokens": t}))(params_s, toks_s)
np.savez(sys.argv[1] + ".ref.npz", out=np.asarray(out), aux=np.asarray(aux, np.float64))
print("REF_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    from repro.configs import get_tiny_config
    from repro.models import Model, init_params
    cfg = get_tiny_config("olmoe-1b-7b").replace(capacity_factor=8.0, dtype="float32",
                                                 param_dtype="float32")
    params = init_params(cfg, jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size))
    ref, ref_aux = Model(cfg).forward(params, {"tokens": toks})
    data = str(tmp_path_factory.mktemp("moe_ep") / "inputs.npz")
    np.savez(data, params=np.array(jax.tree.map(np.asarray, params), dtype=object),
             tokens=toks.astype(np.int64))
    port = str(_free_port())
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port, data],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(REPO)) for r in range(4)]
    procs.append(subprocess.Popen([sys.executable, "-c", REF_SHARDED, data],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env={**env, "JAX_PLATFORMS": "cpu"}, cwd=str(REPO)))
    outs = [p.communicate(timeout=600) for p in procs]
    for r, (o, e) in enumerate(outs[:4]):
        assert f"RANK_OK {r}" in o, o[-2000:] + e[-4000:]
    assert "REF_OK" in outs[4][0], outs[4][0][-2000:] + outs[4][1][-4000:]
    got = np.load(data + ".out.npz")
    ref_s = np.load(data + ".ref.npz")
    return {"ref": np.asarray(ref), "ref_aux": float(ref_aux), **got,
            "ref_sharded": ref_s["out"], "ref_sharded_aux": float(ref_s["aux"])}


def test_moe_sharded_matches_the_single_device_port(outputs):
    err = float(np.max(np.abs(outputs["sharded"] - outputs["local"])))
    assert err < 1e-4, err


def test_moe_sharded_matches_the_reference(outputs):
    err = float(np.max(np.abs(outputs["sharded"] - outputs["ref"])))
    assert err < 1e-4, err


def test_moe_sharded_matches_the_sharded_reference(outputs):
    """Logits and router loss against the reference's own sharded forward
    on the same (2, 2) mesh.  The router loss is the mean of each model
    rank's loss over its own tokens (the reference's ``pmean``), which
    differs from the loss over all tokens (``ref_aux``, the single-device
    path's): a missing ``/n_ranks``, a sum over ranks or the loss over all
    tokens each fails the 1e-6."""
    err = float(np.max(np.abs(outputs["sharded"] - outputs["ref_sharded"])))
    assert err < 1e-4, err
    aux, ref = float(outputs["aux"]), outputs["ref_sharded_aux"]
    assert abs(aux - ref) <= 1e-6, (aux, ref)
    assert abs(ref - outputs["ref_aux"]) > 1e-6    # the all-token loss would not pass


def test_fake_world_trace_has_two_all_to_alls_a_moe_layer():
    """The forward traced over DTensors on a fake world of 4 ranks: each MoE
    layer's interior sends its capacity rows to the expert owners and back,
    two ``all_to_all_single`` nodes over the model group (size 2).
    DTensor's own re-shardings are ``shard_dim_alltoall`` nodes, apart."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_tiny_config
    from repro_torch.distributed.sharding import ShardingEnv, activate
    from repro_torch.launch.dryrun import Leaf, _zip_leaves, trace_fn
    from repro_torch.launch.hlo_analysis import analyze_module, group_size, op_name
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.specs import batch_inputs
    from repro_torch.models import Model
    from repro_torch.models.params import abstract_params
    from repro_torch.training.train_step import batch_pspecs, param_pspecs, to_named
    cfg = get_tiny_config("olmoe-1b-7b").replace(capacity_factor=8.0, dtype="float32",
                                                 param_dtype="float32")
    model = Model(cfg, "cpu", plain_kernels=True)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        env = ShardingEnv(mesh)
        with activate(env):
            params = _zip_leaves(abstract_params(cfg), to_named(env, param_pspecs(cfg, env, 0)),
                                 lambda t, pl: Leaf(t.shape, t.dtype, pl))
            batch = _zip_leaves(batch_inputs(cfg, B, S, kind="prefill"),
                                to_named(env, batch_pspecs(cfg, env, B, kind="prefill")),
                                lambda t, pl: Leaf(t.shape, t.dtype, pl))
            with torch.no_grad():
                gm = trace_fn(lambda p, b: list(model.forward(p, b)), [params, batch], mesh)
            a2a = [n for n in gm.graph.nodes if op_name(n) == "all_to_all_single"]
            assert len(a2a) == 2 * cfg.num_layers
            assert all(group_size(n) == 2 for n in a2a)
            stats = analyze_module(gm)
    assert not dist.is_initialized()
    assert stats["collectives"]["by_kind"]["all-to-all"]["count"] >= 2 * cfg.num_layers
