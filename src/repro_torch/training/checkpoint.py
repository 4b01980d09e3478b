"""Checkpointing with restore onto a device (fault tolerance); counterpart of
``repro/training/checkpoint.py``, in torch and numpy.

Checkpoints are step-scoped directories of one flat-keyed ``arrays.npz`` plus
a JSON manifest (shapes, dtypes, step, data-pipeline state), the reference's
format: bf16 is widened to float32 on disk (npz has no bf16) and the manifest
records float32.  Keys are the reference's (``/``-joined dict keys and list
indices, dict keys sorted).  Given the model config, every parameter-shaped
subtree of the port's layout (a dict whose ``blocks`` is a list of layers:
the parameters, AdamW's moments) is written in the reference's layout,
blocks stacked over depth (``convert.reference_layout``), and read back into
the port's; so either package restores the other's checkpoint.  Saves are
atomic (tmp dir + rename) and optionally asynchronous (the arrays are copied
to the host before the writer thread starts); a retention policy garbage
collects old steps; a leftover ``.tmp_step_*`` of a crashed write is never a
step.  The reference's ``shardings`` (re-placing arrays on another JAX mesh)
becomes ``device``: the port trains on one device.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import port_layout, reference_layout

# torch dtype -> the name numpy (and so the reference's manifest) gives it
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
          torch.float64: "float64", torch.int32: "int32", torch.int64: "int64",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _is_params(tree) -> bool:
    return isinstance(tree, dict) and isinstance(tree.get("blocks"), list)


def _stack_on_host(ts: list) -> torch.Tensor:
    """A block parameter's layers stacked on the host, one at a time off the
    card (a stacked copy of AdamW's state would not fit beside it)."""
    return torch.stack([t.detach().cpu() for t in ts])


def _stack_shape(ts: list) -> torch.Tensor:
    """What restore needs of a stacked leaf: its shape and dtype."""
    return torch.empty((len(ts), *ts[0].shape), dtype=ts[0].dtype, device="meta")


def _to_reference(tree, cfg, stack):
    """The state with each parameter-shaped subtree in the reference's layout."""
    if _is_params(tree):
        return reference_layout(tree, cfg, stack=stack)
    if isinstance(tree, dict):
        return {k: _to_reference(v, cfg, stack) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_reference(v, cfg, stack) for v in tree]
    return tree


def _from_reference(ref, target, cfg):
    """``ref`` (the reference's layout) back into ``target``'s structure,
    each layer's tensor a tensor of its own."""
    if _is_params(target):
        layers = port_layout(ref, cfg)
        layers["blocks"] = [_clone(b) for b in layers["blocks"]]
        if "encoder" in layers:
            layers["encoder"]["blocks"] = [_clone(b) for b in layers["encoder"]["blocks"]]
        return layers
    if isinstance(target, dict):
        return {k: _from_reference(ref[k], v, cfg) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return [_from_reference(r, v, cfg) for r, v in zip(ref, target)]
    return ref


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _flatten(tree, prefix: str = "") -> dict:
    """``{"a/b/0/c": leaf}`` in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(like, flat: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unflatten(v, flat, f"{prefix}{i}/") for i, v in enumerate(like)]
    return flat[prefix[:-1]]


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(v)


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return _NAMES.get(v.dtype, str(v.dtype).replace("torch.", ""))
    return str(np.asarray(v).dtype)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = False, cfg: ModelConfig | None = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.cfg = cfg
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, state, *, extra: dict | None = None):
        """Snapshot to host then write (async-safe: device tensors are copied
        to the host before the writer thread starts)."""
        flat = _flatten(_to_reference(state, self.cfg, _stack_on_host))
        host = {k: _host(v) for k, v in flat.items()}
        manifest = {
            "step": int(step),
            "time": time.time(),
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in host.items()},
            "extra": extra or {},
        }
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, manifest), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, manifest)

    def _write(self, step: int, host: dict, manifest: dict):
        tmp = self.dir / f".tmp_step_{step:09d}"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{k: v for k, v in host.items()})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_state, *, step: int | None = None,
                device=None) -> tuple[object, dict]:
        """Restore into ``target_state``'s structure (tensors of its shapes
        and dtypes), on ``device`` or each target tensor's own.  Returns
        ``(state, extra)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        recorded = manifest.get("arrays", {})
        ref_target = _to_reference(target_state, self.cfg, _stack_shape)
        flat_target = _flatten(ref_target)
        # a stacked leaf's placeholder has no device: it takes the target's
        home = next((leaf.device for leaf in _flatten(target_state).values()
                     if isinstance(leaf, torch.Tensor)), torch.device("cpu"))
        out = {}
        with np.load(d / "arrays.npz") as arrays:
            for key, tgt in flat_target.items():
                a = arrays[key]
                want = tuple(tgt.shape)
                if tuple(a.shape) != want:
                    raise ValueError(
                        f"shape mismatch for {key}: {a.shape} vs {want}")
                stored = recorded.get(key, {}).get("dtype", str(a.dtype))
                tdt = _dtype_name(tgt)
                # bf16 is widened to f32 on save (npz has no bf16), so a
                # float32-on-disk / bfloat16-target pair is the round
                # trip, not a mismatch
                if stored != tdt and not (tdt == "bfloat16" and stored == "float32"):
                    raise ValueError(
                        f"dtype mismatch for {key}: checkpoint has "
                        f"{stored}, target wants {tdt}")
                if isinstance(tgt, torch.Tensor):
                    dev = torch.device(device) if device is not None else (
                        home if tgt.device.type == "meta" else tgt.device)
                    out[key] = torch.from_numpy(np.array(a)).to(device=dev, dtype=tgt.dtype)
                else:
                    out[key] = np.asarray(a).astype(np.asarray(tgt).dtype)
        restored = _from_reference(_unflatten(ref_target, out), target_state, self.cfg)
        return restored, manifest["extra"]


__all__ = ["CheckpointManager"]
