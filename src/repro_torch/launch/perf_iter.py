"""Perf hill-climbing runner (counterpart of ``repro/launch/perf_iter.py``):
trace a cell with a named change (``launch.dryrun.lower_cell`` in a fake
world), extract the three roofline terms (``launch.roofline.cell_terms``,
the H100's constants), and log hypothesis -> before -> after.

    PYTHONPATH=src python -m repro_torch.launch.perf_iter <experiment>

Records go to ``results/torch/perf/``.
"""
import json
import sys
import time
from pathlib import Path

from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.roofline import cell_terms

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch" / "perf"

# experiment := (arch, shape, run_overrides, model_overrides)
EXPERIMENTS = {
    # ---- cell A: qwen2.5-32b train_4k (worst big-model fraction) ----
    "qwen_train.baseline": ("qwen2.5-32b", "train_4k", {}, {}),
    "qwen_train.bf16_scores": ("qwen2.5-32b", "train_4k", {},
                               {"attn_score_dtype": "bfloat16"}),
    "qwen_train.remat_dots": ("qwen2.5-32b", "train_4k",
                              {"remat_policy": "dots"}, {}),
    "qwen_train.bf16+dots": ("qwen2.5-32b", "train_4k",
                             {"remat_policy": "dots"},
                             {"attn_score_dtype": "bfloat16"}),
    "qwen_train.kv_block2048": ("qwen2.5-32b", "train_4k", {},
                                {"attn_kv_block": 2048}),
    "qwen_train.kv_block4096": ("qwen2.5-32b", "train_4k", {},
                                {"attn_kv_block": 4096}),
    # ---- cell B: recurrentgemma-9b train_4k (most collective-bound) ----
    "rg_train.baseline": ("recurrentgemma-9b", "train_4k", {}, {}),
    "rg_train.blockdiag_gates": ("recurrentgemma-9b", "train_4k", {},
                                 {"lru_gate_blocks": 16}),
    "rg_train.blockdiag+zero1": ("recurrentgemma-9b", "train_4k",
                                 {"zero_stage": 1},
                                 {"lru_gate_blocks": 16}),
    "rg_train.blockdiag+bf16s": ("recurrentgemma-9b", "train_4k", {},
                                 {"lru_gate_blocks": 16,
                                  "attn_score_dtype": "bfloat16"}),
    # ---- cell C: qwen2.5-32b decode_32k (serving; paper's DSE theme) ----
    "qwen_decode.baseline": ("qwen2.5-32b", "decode_32k", {}, {}),
    # olmoe collective experiment (EP + FSDP interaction)
    "olmoe_train.baseline": ("olmoe-1b-7b", "train_4k", {}, {}),
    "olmoe_train.zero1": ("olmoe-1b-7b", "train_4k", {"zero_stage": 1}, {}),
    "olmoe_train.cap1.0": ("olmoe-1b-7b", "train_4k", {},
                           {"capacity_factor": 1.0}),
}


def run_experiment(name: str) -> dict:
    arch, shape, run_ov, model_ov = EXPERIMENTS[name]
    t0 = time.time()
    record, _, _ = lower_cell(arch, shape, False, run_overrides=run_ov,
                              model_overrides=model_ov)
    terms = cell_terms(record)
    out = {"experiment": name, "arch": arch, "shape": shape,
           "run_overrides": run_ov, "model_overrides": model_ov,
           "terms": terms,
           "memory_analysis": record.get("memory_analysis"),
           "collectives_by_kind": record["collectives"]["by_kind"],
           "wall_s": round(time.time() - t0, 1)}
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / f"{name}.json").write_text(json.dumps(out, indent=1))
    return out


def main():
    names = sys.argv[1:] or list(EXPERIMENTS)
    for name in names:
        if name not in EXPERIMENTS:
            print(f"unknown experiment {name}")
            continue
        out = (RESULTS / f"{name}.json")
        if out.exists():
            r = json.loads(out.read_text())
            print(f"[cached] {name}")
        else:
            r = run_experiment(name)
        t = r["terms"]
        print(f"{name:30s} compute={t['compute_s']:8.3f}s memory={t['memory_s']:8.3f}s "
              f"collective={t['collective_s']:7.3f}s dom={t['dominant']} "
              f"frac={t['roofline_fraction']:.4f}", flush=True)


if __name__ == "__main__":
    main()
