"""Roofline analysis from dry-run records (counterpart of
``repro/launch/roofline.py``), with the H100's constants.

Per (arch x shape) cell:
    compute term    = flops_per_device / bf16 peak        [s]
    memory term     = hbm_bytes_per_device / HBM rate     [s]
    collective term = ring traffic per device / link rate [s]
(the dry-run records are already per-device — see launch/hlo_analysis.py),
plus MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·B (decode), the
useful-compute ratio, the dominant term, and a what-would-move-it note.

The constants are ``HARDWARE["h100_sxm"]``'s: ``peak_flops["bf16"]``,
``hbm_bw`` and ``intra.bandwidth`` (NVLink, one direction).  The reference's
single-pod mesh has a 16-wide model axis, which on H100s spans two 8-GPU
NVLink nodes, so part of its collectives cross the slower inter-node links
and ``intra.bandwidth`` flatters the collective term there.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.core.backend.hardware import HARDWARE

_H100 = HARDWARE["h100_sxm"]
PEAK_FLOPS = _H100.peak_flops["bf16"]
HBM_BW = _H100.hbm_bw
LINK_BW = _H100.intra.bandwidth

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch"


def cell_terms(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    shape = SHAPES[rec["shape"]]
    n_active = rec["active_params"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    n_dev = rec["n_devices"]
    t_c = rec["flops_per_device"] / PEAK_FLOPS
    t_m = rec["hbm_bytes_per_device"] / HBM_BW
    t_x = rec["collectives"]["traffic_bytes"] / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = model_flops / n_dev / PEAK_FLOPS     # ideal per-device seconds
    return {
        "arch": rec["arch"], "shape": rec["shape"], "kind": shape.kind,
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dom,
        "model_flops": model_flops,
        "hlo_to_model_flops": rec["flops_per_device"] * n_dev / model_flops
        if model_flops else float("inf"),
        "roofline_fraction": useful / bound if bound > 0 else 0.0,
        "mem_args_gb": (rec["memory_analysis"].get("argument_bytes") or 0) / 1e9,
        "mem_temp_gb": (rec["memory_analysis"].get("temp_bytes") or 0) / 1e9,
    }


_NOTES = {
    "compute": "cut redundant FLOPs: causal-block skipping, remat policy "
               "(dots), drop MoE capacity padding",
    "memory": "reduce bytes: weight/KV quantization, larger fusion regions, "
              "wider batch to amortise weight streaming",
    "collective": "reduce traffic: ZeRO stage, collective dtype, capacity "
                  "factor, comm/compute overlap schedule",
}


def load_all(mesh: str = "single") -> list[dict]:
    rows = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            f = RESULTS / "dryrun" / f"{arch}__{shape}__{mesh}.json"
            if not f.exists():
                continue
            t = cell_terms(json.loads(f.read_text()))
            if t:
                rows.append(t)
    return rows


def to_markdown(rows: list[dict]) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | dominant | "
           "MODEL/HLO flops | roofline frac | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | {r['dominant']} | "
            f"{1.0 / r['hlo_to_model_flops']:.2f} | {r['roofline_fraction']:.3f} | "
            f"{_NOTES[r['dominant']][:46]} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    rows = load_all(args.mesh)
    if not rows:
        raise SystemExit(f"no dry-run records under {RESULTS / 'dryrun'}: "
                         "run python -m repro_torch.launch.dryrun first")
    rows.sort(key=lambda r: r["roofline_fraction"])
    if args.json:
        print(json.dumps(rows, indent=1))
    else:
        print(to_markdown(rows))
        print(f"\n{len(rows)} cells; worst fraction: {rows[0]['arch']}/{rows[0]['shape']}"
              f" = {rows[0]['roofline_fraction']:.4f}")
        coll = max(rows, key=lambda r: r["collective_s"] /
                   max(r["compute_s"], r["memory_s"], 1e-12))
        print(f"most collective-bound: {coll['arch']}/{coll['shape']} "
              f"(coll {coll['collective_s']:.3f}s vs max-other "
              f"{max(coll['compute_s'], coll['memory_s']):.3f}s)")
    (RESULTS / f"roofline_{args.mesh}.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
