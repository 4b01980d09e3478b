"""Simulator facade: end-to-end LLM training/inference performance prediction.

Composition (paper Fig. 3): native ingestion (model_ingest/tracer) ->
parallelism & optimization passes -> multi-engine operator pricing ->
dependency-aware scheduling + overlap modeling -> multi-granularity reports
(end-to-end time, MFU, memory, per-op breakdown, chrome traces, PP timeline).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import pickle
from dataclasses import dataclass, field

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend.analytical import AnalyticalEngine
from repro_torch.core.backend.collectives import (
    GroupSpec, collective_memo_clear, collective_memo_stats,
    hierarchical_collective_time_us,
)
from repro_torch.core.backend.engine import FusedEngine
from repro_torch.core.backend.hardware import HARDWARE, HardwareSpec
from repro_torch.core.backend.prediction import PredictionEngine
from repro_torch.core.backend.profiling import ProfileDB, ProfilingEngine
from repro_torch.core.ir import Graph
from repro_torch.core.memory import MemoryReport, block_liveness, simulate_memory
from repro_torch.core.model_ingest import ModelGraphs, ingest_graphs, ingest_key
from repro_torch.core.overlap import apply_bandwidth_aware, apply_ratio_overlap
from repro_torch.core.passes.base import ParallelConfig, PassContext, PassManager
from repro_torch.core.simcache import SimCache
from repro_torch.core.passes.data_parallel import optimizer_step_cost
from repro_torch.core.passes.fusion import FusionPass
from repro_torch.core.passes.parallelism import (
    ContextParallelPass, ExpertParallelPass, SequenceParallelPass,
    TensorParallelPass,
)
from repro_torch.core.passes.pipeline import PPSchedule, make_schedule
from repro_torch.core.passes.quantize import QuantizePass
from repro_torch.core.passes.recompute import RecomputePass
from repro_torch.core.scheduler import Timeline, schedule, schedule_times
from repro_torch.models.kvcache import cache_bytes
from repro_torch.models.params import block_cycle, build_params, count_params


@dataclass
class Report:
    mode: str
    step_time_us: float
    chips: int
    tokens_per_step: float
    tokens_per_s: float
    tps_per_chip: float
    mfu: float
    model_flops: float
    breakdown_us: dict = field(default_factory=dict)     # phase -> us
    kind_us: dict = field(default_factory=dict)          # op kind -> us
    memory: MemoryReport | None = None
    pp: PPSchedule | None = None
    block_timelines: dict = field(default_factory=dict)  # kind -> Timeline
    detail: dict = field(default_factory=dict)

    # serving metrics
    @property
    def tpot_ms(self) -> float:
        return self.step_time_us / 1e3 if self.mode == "decode" else float("nan")

    @property
    def ttft_ms(self) -> float:
        return self.step_time_us / 1e3 if self.mode == "prefill" else float("nan")

    # ---- attribution (repro_torch.obs.explain) ----
    def explain(self, top_k: int = 8) -> str:
        """Plain-text attribution: phase breakdown, top-k op kinds,
        compute-vs-comm split; with ``keep_timelines=True`` reports also
        the critical path, per-op comm bytes and exposed-comm overlap."""
        from repro_torch.obs.explain import render_report
        return render_report(self, top_k=top_k)

    def explain_dict(self, top_k: int = 8) -> dict:
        """Structured form of :meth:`explain` (what sweep manifests embed)."""
        from repro_torch.obs.explain import explain_report
        return explain_report(self, top_k=top_k)


def shard_memory_floor(cfg: ModelConfig, par: ParallelConfig, B_local: int,
                       mode: str, cache_len: int) -> tuple[float, float]:
    """(per-device parameter bytes, per-device KV-cache bytes) after sharding.

    Single source of truth shared by ``simulate()``'s memory report and the
    explorer's ``rule_memory_fit`` pre-filter — the pre-filter's lower-bound
    guarantee only holds while both sides use the same formulas.
    """
    param_dev = 2 * count_params(cfg) / max(par.tp * par.pp, 1)
    if par.zero_stage >= 3:
        param_dev /= max(par.dp * par.pods, 1)
    # KV cache shards over the model axis (heads when divisible, else the
    # KV sequence — see models/kvcache.py)
    kvb = cache_bytes(cfg, B_local, cache_len) / max(par.tp, 1) \
        if mode == "decode" else 0.0
    return param_dev, kvb


@dataclass
class _BlockStage:
    """Priced per-block sub-results shared by sweep candidates with equal
    (model, B_local, S, mode, cache_len, shard_key, pipeline) keys."""
    graphs: ModelGraphs
    t_fwd: dict
    t_bwd: dict
    kind_us: dict
    first_fwd: Graph                 # post-pass first decoder block (memory)
    first_joint: Graph | None
    timelines: dict
    livekey: tuple = ()              # memory-liveness cache key (no engine ver)


class Simulator:
    def __init__(self, hw: str | HardwareSpec = "h100_sxm",
                 engine: str = "analytical", db: ProfileDB | None = None,
                 *, overlap: str = "ratio", measure_on_miss: bool = False,
                 cache: bool = True, persist: str | None = None,
                 sanitize: bool | None = None):
        self.hw = HARDWARE[hw] if isinstance(hw, str) else hw
        self.db = db or ProfileDB()
        self.overlap = overlap
        # sanitize=None defers to the CHARON_SANITIZE env knob; when on,
        # the cache fingerprints values at insert and re-verifies at hit
        # (cache-poisoning detector — see repro_torch.analysis.sanitize).  The
        # default path constructs a plain SimCache with no fingerprinting
        # code anywhere near the hot get().
        if sanitize is None:
            sanitize = os.environ.get("CHARON_SANITIZE", "") not in ("", "0")
        self.sanitize = bool(sanitize)
        if self.sanitize:
            from repro_torch.analysis.sanitize import SanitizingSimCache
            self.cache = SanitizingSimCache(enabled=cache)
        else:
            self.cache = SimCache(enabled=cache)
        engines = []
        if engine in ("fused", "profiling"):
            engines.append(ProfilingEngine(self.hw, self.db,
                                           measure_on_miss=measure_on_miss))
        if engine in ("fused", "prediction"):
            engines.append(PredictionEngine(self.hw, self.db))
        engines.append(AnalyticalEngine(self.hw))
        if engine == "analytical":
            engines = [AnalyticalEngine(self.hw)]
        elif engine == "profiling":
            engines = [engines[0], engines[-1]]
        elif engine == "prediction":
            engines = [e for e in engines if e.name in ("prediction", "analytical")]
        self.engine = FusedEngine(engines, cache=cache)
        # persistent cross-run tier: explicit ``persist=`` dir, else the
        # CHARON_CACHE_DIR environment knob (loads are automatic; writes
        # only happen on an explicit save_cache() call)
        persist = persist or os.environ.get("CHARON_CACHE_DIR")
        if persist and cache:
            path = (f"simcache-{self.hw.name}-"
                    f"{'+'.join(e.name for e in self.engine.engines)}"
                    f"-{overlap}.pkl")
            pricing = self.cache.attach_persistent(
                os.path.join(os.path.expanduser(persist), path),
                self._persist_meta())
            if pricing and self.engine._cache is not None:
                self.engine._cache.update(pricing)

    def _persist_meta(self) -> dict:
        """Versioned identity of everything the persisted entries depend on.
        Computed fresh at attach AND at save time: a profile-DB mutated
        after construction must be described by its *mutated* digest, so a
        process with the original DB can never load entries priced under
        the new state (and vice versa)."""
        import repro_torch
        from repro_torch.core.simcache import CACHE_FORMAT
        digest = "|".join(f"{e.name}:{int(getattr(e, 'state_version', 0))}"
                          for e in self.engine.engines)
        if self.db.data:
            digest += "|db:" + hashlib.sha1(json.dumps(
                self.db.data, sort_keys=True, default=str)
                .encode()).hexdigest()
        return {"format": CACHE_FORMAT, "repro_torch": repro_torch.__version__,
                "torch": torch.__version__, "hw": self.hw.name,
                "overlap": self.overlap, "engines": digest}

    def save_cache(self):
        """Write the persistent tier to disk (no-op without ``persist=`` /
        ``CHARON_CACHE_DIR``).  Returns the written path or None."""
        return self.cache.save_persistent(
            self.engine._cache if self.engine._cache else None,
            meta=self._persist_meta())

    def save_cache_shard(self, tag: str):
        """Write this process's cache as a per-worker *shard* next to the
        attached persistent file (``<main>.<tag>.<pid>.shard``) instead of
        racing other workers on the main path.  The sweep parent unions
        shards back via :func:`merge_cache_shards` once workers are done.
        No-op (None) without an attached persistent tier."""
        if self.cache.persist_path is None:
            return None
        shard = self.cache.persist_path.with_name(
            f"{self.cache.persist_path.name}.{tag}.{os.getpid()}.shard")
        return self.cache.save_persistent(
            self.engine._cache if self.engine._cache else None,
            meta=self._persist_meta(), path=shard)

    def cache_stats(self) -> dict:
        """Hit/miss counters for every cache layer (benchmark telemetry)."""
        out = self.cache.stats_dict()
        out["pricing"] = self.engine.stats.as_dict()
        # module-level memo: counters aggregate over all simulators
        out["collectives"] = collective_memo_stats().as_dict()
        return out

    def metrics_registry(self, registry=None):
        """Fill a :class:`~repro_torch.obs.MetricsRegistry` (created when None)
        with every stats surface this simulator exposes — the one-call form
        of the scattered ``cache_stats()`` / extrapolation dicts.  Snapshot
        before and after a run and ``MetricsRegistry.diff`` the two to cost
        just that run."""
        from repro_torch.obs import MetricsRegistry
        if registry is None:
            registry = MetricsRegistry()
        registry.update_from_simulator(self)
        return registry

    def cache_clear(self) -> None:
        self.cache.clear()
        self.engine.cache_clear()
        collective_memo_clear()

    # ------------------------------------------------------------------
    def _passes(self, cfg: ModelConfig, par: ParallelConfig, *,
                fusion: bool, quantize: str | None, remat: str,
                train: bool) -> PassManager:
        pm = PassManager()
        pm.add(TensorParallelPass())
        if cfg.num_kv_heads % max(par.tp, 1) != 0:
            # heads unshardable -> Ulysses-style context parallelism on the
            # same chips (mirrors the substrate's divisibility fallback)
            pm.add(ContextParallelPass(cp=par.tp))
        if par.sp > 1:
            pm.add(SequenceParallelPass())
        if cfg.num_experts:
            pm.add(ExpertParallelPass(cfg.num_experts))
        if fusion:
            pm.add(FusionPass())
        if quantize:
            pm.add(QuantizePass(quantize))
        if train and remat != "none":
            pm.add(RecomputePass(remat))
        return pm

    def _time(self, g: Graph) -> tuple[float, Timeline]:
        tl = schedule(g, self.engine)
        tl = (apply_bandwidth_aware if self.overlap == "bandwidth"
              else apply_ratio_overlap)(tl, self.hw)
        return tl.total_time, tl

    # ------------------------------------------------------------------
    def _block_stage(self, cfg: ModelConfig, mode: str, B_local: int, S: int,
                     cache_len: int, par: ParallelConfig, *, fusion: bool,
                     quantize: str | None, remat: str,
                     keep_timelines: bool) -> _BlockStage:
        """Trace, transform and price all block graphs — the dominant cost of
        one ``simulate`` call, memoized across candidates that share shapes.

        Three cache layers compose: ``ingest`` (traced graphs), ``passes``
        (post-``PassManager`` graphs), ``block_times`` (the whole priced
        stage).  ``keep_timelines=True`` bypasses the ``block_times`` layer
        (timelines are per-call artifacts) but still reuses the lower two.
        """
        train = mode == "train"
        # fast path: totals via running scalars, no per-node Interval
        # allocation — the bandwidth-aware model joins via its
        # flow-compressed schedule_times variant; traces need timelines
        use_fast = not keep_timelines
        ikey = ingest_key(cfg, B_local, S, mode, cache_len)
        pm = self._passes(cfg, par, fusion=fusion, quantize=quantize,
                          remat=remat, train=train)
        pm_sig = pm.signature()
        shard = par.shard_key()

        def build() -> _BlockStage:
            mg = self.cache.get("ingest", ikey, lambda: ingest_graphs(
                cfg, B_local, S, mode, cache_len=cache_len))
            ctx = PassContext(parallel=par, model=cfg)

            def passed(g: Graph, kind: str, which: str) -> Graph:
                return self.cache.get(
                    "passes", (ikey, kind, which, pm_sig, shard),
                    lambda: pm.run(g.clone(), ctx))

            t_fwd: dict[str, float] = {}
            t_bwd: dict[str, float] = {}
            kind_us: dict[str, float] = {}
            timelines: dict[str, Timeline] = {}
            first_kind = mg.blocks[0].kind
            first_fwd = first_joint = None
            for bg in mg.all_blocks():
                fwd = passed(bg.fwd, bg.kind, "fwd")
                if use_fast:
                    tf, bk = schedule_times(fwd, self.engine, self.hw,
                                            overlap=self.overlap)
                else:
                    tf, tlf = self._time(fwd)
                    bk = tlf.by_kind()
                    if keep_timelines:
                        timelines[bg.kind] = tlf
                t_fwd[bg.kind] = tf
                for k, v in bk.items():
                    kind_us[k] = kind_us.get(k, 0.0) + v * bg.repeat
                if bg.kind == first_kind:
                    first_fwd = fwd
                if train and bg.joint is not None:
                    joint = passed(bg.joint, bg.kind, "joint")
                    tj = schedule_times(joint, self.engine, self.hw,
                                          overlap=self.overlap)[0] \
                        if use_fast else self._time(joint)[0]
                    t_bwd[bg.kind] = max(tj - tf, tf)  # bwd >= fwd in practice
                    if bg.kind == first_kind:
                        first_joint = joint
                else:
                    t_bwd[bg.kind] = 0.0
            return _BlockStage(mg, t_fwd, t_bwd, kind_us,
                               first_fwd, first_joint, timelines,
                               livekey=(ikey, pm_sig, shard))

        if keep_timelines:
            return build()
        # engine state version: profiling-DB/prediction-model mutation must
        # not serve stale priced stages (matches the FusedEngine price memo)
        skey = (ikey, pm_sig, shard, self.engine._state_version())
        return self.cache.get("block_times", skey, build)

    # ------------------------------------------------------------------
    def run(self, spec, *, keep_timelines: bool = False,
            recorder=None, metrics=None) -> Report:
        """Simulate one :class:`repro_torch.api.spec.SimSpec` — the primary entry
        point.  The spec's cluster must name this simulator's hardware;
        serving workloads belong to ``ServingSimulator.run``.

        ``recorder`` (a :class:`~repro_torch.obs.TraceRecorder`) captures the
        priced block timelines and pipeline schedule as trace lanes; it
        forces ``keep_timelines=True`` internally (there is nothing to
        record without them) but the returned report is numerically
        identical to the fast path either way.  ``metrics`` (a
        :class:`~repro_torch.obs.MetricsRegistry`) adopts this simulator's cache
        and extrapolation counters after the run; both default to off and
        cost one ``is None`` check on the fast path."""
        if spec.cluster.hardware != self.hw.name:
            raise ValueError(
                f"simulator built for {self.hw.name!r} cannot run a spec for "
                f"cluster hardware {spec.cluster.hardware!r}")
        w = spec.workload
        if getattr(w, "mode", None) == "serving":
            raise TypeError("serving workloads are request-level: use "
                            "ServingSimulator(sim).run(spec)")
        if recorder is not None and recorder.enabled:
            from repro_torch.core.timeline import record_report
            rep = self._simulate(spec.model, par=spec.parallel,
                                 keep_timelines=True, **w.sim_kwargs())
            record_report(recorder, rep)
        elif keep_timelines or not self.cache.persistent:
            rep = self._simulate(spec.model, par=spec.parallel,
                                 keep_timelines=keep_timelines,
                                 **w.sim_kwargs())
        else:
            # cross-run memo (persistent tier attached): the stable spec
            # JSON hash is the on-disk key, the engine state version rides
            # along so a profile-DB put / prediction retrain can never
            # serve a stale Report
            key = (spec.json_hash(), self.engine._state_version())
            rep = self.cache.get(
                "reports", key,
                lambda: self._simulate(spec.model, par=spec.parallel,
                                       **w.sim_kwargs()))
        if metrics is not None:
            metrics.inc("sim.runs")
            metrics.update_from_simulator(self)
        return rep

    def simulate(self, cfg: ModelConfig, *, mode: str = "train",
                 global_batch: int = 8, seq_len: int = 2048,
                 par: ParallelConfig | None = None, remat: str = "block",
                 optimizer: str = "adamw", fusion: bool = False,
                 quantize: str | None = None, cache_len: int = 0,
                 keep_timelines: bool = False) -> Report:
        """Deprecated kwargs shim for external callers: builds the
        equivalent :class:`~repro_torch.api.spec.SimSpec` and delegates to
        :meth:`run` (bit-identical by construction)."""
        import warnings

        from repro_torch.api.spec import CharonDeprecationWarning, SimSpec
        warnings.warn(
            "Simulator.simulate(**kwargs) is deprecated; build a SimSpec "
            "and call Simulator.run(spec) (see docs/api.md)",
            CharonDeprecationWarning, stacklevel=2)
        spec = SimSpec.from_legacy(
            cfg, self.hw, mode=mode, global_batch=global_batch,
            seq_len=seq_len, par=par, remat=remat, optimizer=optimizer,
            fusion=fusion, quantize=quantize, cache_len=cache_len)
        return self.run(spec, keep_timelines=keep_timelines)

    def _simulate(self, cfg: ModelConfig, *, mode: str = "train",
                  global_batch: int = 8, seq_len: int = 2048,
                  par: ParallelConfig | None = None, remat: str = "block",
                  optimizer: str = "adamw", fusion: bool = False,
                  quantize: str | None = None, cache_len: int = 0,
                  keep_timelines: bool = False) -> Report:
        par = par or ParallelConfig()
        dp_total = max(par.dp * par.pods, 1)
        B_local = max(global_batch // dp_total, 1)
        train = mode == "train"

        stage = self._block_stage(
            cfg, mode, B_local, seq_len if mode != "decode" else 1,
            cache_len or seq_len, par, fusion=fusion, quantize=quantize,
            remat=remat, keep_timelines=keep_timelines)
        mg = stage.graphs
        t_fwd = stage.t_fwd
        t_bwd = stage.t_bwd
        kind_us = dict(stage.kind_us)   # copy: stage may be cache-shared
        timelines = dict(stage.timelines)

        # ---- stack totals ----
        dec_blocks = [b for b in mg.blocks]
        total_layers = sum(b.repeat for b in dec_blocks)
        t_f_layers = sum(t_fwd[b.kind] * b.repeat for b in dec_blocks)
        t_b_layers = sum(t_bwd[b.kind] * b.repeat for b in dec_blocks)
        t_f_head = t_fwd.get("head", 0.0)
        t_b_head = t_bwd.get("head", 0.0)
        t_f_enc = t_fwd.get("enc", 0.0) * (mg.encoder.repeat if mg.encoder else 0)
        t_b_enc = t_bwd.get("enc", 0.0) * (mg.encoder.repeat if mg.encoder else 0)

        pp, m = par.pp, max(par.microbatches, 1)
        # inter-stage p2p payload per microbatch
        act_bytes = B_local * (seq_len if mode != "decode" else 1) * cfg.d_model * 2 / m
        t_p2p = hierarchical_collective_time_us(
            "send", act_bytes, GroupSpec(intra_size=2), self.hw)

        if train:
            t_f_stage = (t_f_layers / pp + (t_f_enc + t_f_head) / pp) / m
            t_b_stage = (t_b_layers / pp + (t_b_enc + t_b_head) / pp) / m
            sched = make_schedule(par.pp_schedule, pp, m, t_f_stage, t_b_stage, t_p2p)
            t_compute = sched.total_time
            # DP gradient sync (overlappable with backward) + optimizer
            n_params = count_params(cfg)
            shard = par.tp * pp * (max(par.ep, 1) if cfg.num_experts else 1)
            grad_bytes = 2 * n_params / max(shard, 1)
            t_dp = hierarchical_collective_time_us(
                "all_reduce" if par.zero_stage == 0 else "reduce_scatter",
                grad_bytes, GroupSpec(par.dp, par.pods), self.hw)
            if par.zero_stage >= 1:
                t_dp += hierarchical_collective_time_us(
                    "all_gather", grad_bytes, GroupSpec(par.dp, par.pods), self.hw)
            bwd_window = sched.total_time * (t_b_stage / max(t_f_stage + t_b_stage, 1e-9))
            exposed_dp = max(0.0, t_dp - 0.8 * bwd_window) + 0.2 * t_dp
            o_flops, o_bytes = optimizer_step_cost(
                n_params / max(shard, 1), optimizer=optimizer,
                zero_stage=par.zero_stage, dp=dp_total)
            n_leaves = _param_leaves(cfg)
            t_opt = max(o_flops / self.hw.flops_for("f32"),
                        o_bytes / self.hw.hbm_bw) * 1e6 \
                + 3 * n_leaves * self.hw.dispatch_us  # m/v/p update dispatches
            total = t_compute + exposed_dp + t_opt
            breakdown = {"fwd": t_f_layers + t_f_enc + t_f_head,
                         "bwd": t_b_layers + t_b_enc + t_b_head,
                         "pp_bubble": sched.total_time - (t_f_layers + t_b_layers
                                                          + t_f_enc + t_b_enc
                                                          + t_f_head + t_b_head) / pp,
                         "dp_sync_exposed": exposed_dp, "optimizer": t_opt}
        else:
            sched = None
            total = t_f_layers + t_f_enc + t_f_head + (pp - 1) * t_p2p
            breakdown = {"fwd": t_f_layers + t_f_enc + t_f_head,
                         "pp_latency": (pp - 1) * t_p2p}

        # ---- metrics ----
        chips = par.chips
        n_active = count_params(cfg, active_only=True)
        tokens = global_batch * (seq_len if mode != "decode" else 1)
        model_flops = (6 if train else 2) * n_active * tokens
        peak = self.hw.flops_for("bf16")
        mfu = model_flops / (chips * peak * total / 1e6) if total else 0.0

        # ---- memory ----
        # expert shard already inside the tp*pp approximation for MoE
        param_dev, kvb = shard_memory_floor(cfg, par, B_local, mode,
                                            cache_len or seq_len)
        # the liveness walk re-reads only the transformed first block, so it
        # is keyed like the block stage minus the engine version (pricing
        # mutations cannot change activation bytes)
        mem_mode = "train" if train else mode
        block_joint = stage.first_joint if train else None
        liveness = self.cache.get(
            "memory", stage.livekey,
            lambda: block_liveness(stage.first_fwd, block_joint, mem_mode))
        mem = simulate_memory(
            stage.first_fwd, n_layers=total_layers // pp,
            param_bytes=param_dev,
            boundary_bytes=B_local * (seq_len if mode != "decode" else 1)
            * cfg.d_model * 2 / max(par.sp, 1),
            mode=mem_mode, optimizer=optimizer,
            zero_stage=par.zero_stage, dp=dp_total, tp=par.tp, remat=remat,
            kv_cache_bytes=kvb,
            block_joint=block_joint, liveness=liveness)

        return Report(
            mode=mode, step_time_us=total, chips=chips,
            tokens_per_step=tokens,
            tokens_per_s=tokens / (total / 1e6) if total else 0.0,
            tps_per_chip=tokens / (total / 1e6) / chips if total else 0.0,
            mfu=mfu, model_flops=model_flops,
            breakdown_us=breakdown, kind_us=kind_us, memory=mem, pp=sched,
            block_timelines=timelines,
            detail={"t_fwd": dict(t_fwd), "t_bwd": dict(t_bwd),
                    "B_local": B_local, "par": par},
        )


def _param_leaves(cfg: ModelConfig) -> int:
    """Parameter leaves as the reference counts them: its tree stacks a
    block's parameters over the layers at one cycle position, so a cycle
    position is one set of leaves, however many layers share it (the port's
    tree has one set a layer), and so is an encoder's stack."""
    cycle, _, tail = block_cycle(cfg)
    leaves = [0]

    def c(path, shape, logical, fan_in):
        leaves[0] += 1

    build_params(cfg.replace(num_layers=len(cycle) + len(tail),
                             encoder_layers=min(cfg.encoder_layers, 1)), c)
    return leaves[0]


def merge_cache_shards(main_path, shard_paths, *, metrics=None) -> dict:
    """Union per-worker cache shards into the main persistent file.

    Robustness contract (tests/test_pool_robustness.py):

    * a corrupt or partially-written shard (killed worker, injected
      ``cache_corrupt``) is **quarantined** — renamed ``<shard>.corrupt``,
      counted as ``pool.cache_shards_quarantined`` — and the sweep degrades
      to cold pricing for those entries instead of raising;
    * a shard whose metadata disagrees with the main file / its siblings
      (stale worker from an older engine state) is skipped, never merged;
    * the main file is rewritten atomically (tmp + ``os.replace``) and
      merged shards are deleted, so a crash mid-merge leaves either the old
      main or the new one — never a partial file.

    Returns ``{"merged": n, "quarantined": n, "skipped": n, "path": ...}``.
    """
    from pathlib import Path

    from repro_torch.core.simcache import SimCache, atomic_pickle

    main_path = Path(main_path)
    summary = {"merged": 0, "quarantined": 0, "skipped": 0,
               "path": str(main_path)}

    def _load(path: Path) -> dict | None:
        try:
            with open(path, "rb") as f:
                blob = pickle.load(f)
            # shallow shape check: a truncated pickle usually raises above,
            # but guard the layout too before trusting .get() results
            if not isinstance(blob, dict) or "meta" not in blob:
                raise ValueError("unexpected shard layout")
            return blob
        except FileNotFoundError:
            return None
        except Exception:
            corrupt = path.with_name(path.name + ".corrupt")
            try:
                os.replace(path, corrupt)
            except OSError:
                pass
            summary["quarantined"] += 1
            if metrics is not None:
                metrics.inc("pool.cache_shards_quarantined")
            return None

    base = _load(main_path) if main_path.exists() else None
    meta = base["meta"] if base else None
    buckets: dict[str, dict] = {b: {} for b in SimCache.PERSISTED}
    pricing: dict = {}
    if base:
        for b in SimCache.PERSISTED:
            buckets[b].update(base.get("buckets", {}).get(b) or {})
        pricing.update(base.get("pricing") or {})

    merged_paths = []
    for path in sorted(Path(p) for p in shard_paths):
        blob = _load(path)
        if blob is None:
            continue
        if meta is None:
            meta = blob["meta"]          # first good shard defines identity
        if blob["meta"] != meta:
            summary["skipped"] += 1      # stale worker: never merge
            if metrics is not None:
                metrics.inc("pool.cache_shards_skipped")
            continue
        for b in SimCache.PERSISTED:
            buckets[b].update(blob.get("buckets", {}).get(b) or {})
        pricing.update(blob.get("pricing") or {})
        summary["merged"] += 1
        merged_paths.append(path)

    if summary["merged"]:
        atomic_pickle(main_path, {"meta": meta, "buckets": buckets,
                                  "pricing": pricing})
        if metrics is not None:
            metrics.inc("pool.cache_shards_merged", summary["merged"])
    for path in merged_paths:
        try:
            os.unlink(path)
        except OSError:
            pass
    return summary
