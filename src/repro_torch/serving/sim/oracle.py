"""Step-time oracle: the core ``Simulator`` as a (mode, batch, context) pricer.

The event loop asks "how long does ONE engine iteration take?" thousands of
times per trace.  Answers repeat heavily once batch size and context length
are bucketed (rounded up to the next power of two), so misses — a full
``Simulator.simulate`` call on one replica — are rare and everything else is
served from the simulator's :class:`~repro_torch.core.simcache.SimCache`
``serving`` bucket, which makes oracle hit rates visible in
``Simulator.cache_stats()`` next to every other cache layer.

Replica pricing: the oracle forces ``dp = pods = 1`` on the candidate's
:class:`~repro_torch.core.passes.base.ParallelConfig` — the event loop models a
single engine instance, and the explorer's goodput objective splits the
workload over (and multiplies goodput back by) the replica count.  TP/PP/
EP/SP stay, so sharding and pipeline-latency effects are still priced.

Bucketing rounds *up*, so prices are mildly conservative (a batch of 9 pays
the batch-16 step); ``ctx_floor`` bounds the number of distinct context
buckets, which bounds cold ingest traces per sweep.

When the owning simulator has a persistent tier attached
(``Simulator(persist=dir)`` / ``CHARON_CACHE_DIR``), the ``serving`` bucket
— bucketed spec keys and their priced ``Report``s — survives across
processes, so a repeated serving benchmark replays its whole trace without
a single ingest trace; oracle misses additionally land in the cross-run
``reports`` tier via ``Simulator.run``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.api.spec import Cluster, DecodeWorkload, PrefillWorkload, SimSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.core.passes.base import ParallelConfig
from repro_torch.core.simulator import Simulator


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


@dataclass
class StepOracle:
    sim: Simulator
    cfg: ModelConfig
    par: ParallelConfig = field(default_factory=ParallelConfig)
    ctx_floor: int = 256        # min context bucket (bounds distinct keys)
    seq_floor: int = 16         # min prefill-length bucket
    lookups: int = 0

    def __post_init__(self):
        self._par1 = replace(self.par, dp=1, pods=1, microbatches=1)
        self._cluster = Cluster(self.sim.hw)
        self._specs: dict[tuple, SimSpec] = {}
        self._price: dict[tuple, float] = {}
        self._raw: dict[tuple, float] = {}
        self._memo_ver = None       # engine state version the memos are for
        # sanitize mode (CHARON_SANITIZE / Simulator(sanitize=True)):
        # every memo fast-path hit is re-verified against the authoritative
        # serving-bucket price; off path is this one attribute check
        self._sanitize = bool(getattr(self.sim, "sanitize", False))

    @classmethod
    def from_spec(cls, sim: Simulator, spec) -> "StepOracle":
        """The oracle a serving/fleet run of ``spec`` prices through — one
        instance per run, shared by every replica of a fleet (replicas are
        identical engines, so their step prices are one bucketed table)."""
        return cls(sim, spec.model, spec.parallel,
                   ctx_floor=spec.workload.ctx_floor)

    def _spec_for(self, mode: str, B: int, S: int, cache_len: int) -> SimSpec:
        """Bucket tuple -> SimSpec, memoized: spec construction + the nested
        hash are not free and this sits on the per-engine-step hot path."""
        k = (mode, B, S, cache_len)
        spec = self._specs.get(k)
        if spec is None:
            wcls = DecodeWorkload if mode == "decode" else PrefillWorkload
            spec = SimSpec(self.cfg, cluster=self._cluster,
                           parallel=self._par1,
                           workload=wcls(global_batch=B, seq_len=S,
                                         cache_len=cache_len))
            self._specs[k] = spec
        return spec

    # ------------------------------------------------------------------
    def _memos_live(self, ver=None) -> bool:
        """The ``_raw``/``_price`` front memos are valid only while the sim
        cache is enabled and the engine state version is unchanged: a
        profile-DB put or prediction retrain evicts both wholesale (rather
        than keying each entry on the version, which would leak dead entries
        across retrains in long-lived simulators)."""
        if not self.sim.cache.enabled:
            return False
        if ver is None:
            ver = self.sim.engine._state_version()
        if ver != self._memo_ver:
            self._raw.clear()
            self._price.clear()
            self._memo_ver = ver
        return True

    def _priced_s(self, mode: str, B: int, S: int, cache_len: int) -> float:
        self.lookups += 1
        # fast path: hashing a nested frozen SimSpec costs ~15 us and a fleet
        # trace prices millions of steps, so repeat lookups resolve through a
        # plain bucket-tuple memo (_memos_live keeps invalidation intact)
        ver = self.sim.engine._state_version()
        fast = (mode, B, S, cache_len)
        if self._memos_live(ver):
            price = self._price.get(fast)
            if price is not None:
                self.sim.cache.stats["serving"].hits += 1  # semantically a hit
                if self._sanitize:
                    self._verify_memo("_price", fast, price, ver)
                return price
        spec = self._spec_for(mode, B, S, cache_len)
        # the bucketed spec IS the cache key; the engine state version rides
        # along so a profile-DB put or prediction retrain can never serve a
        # stale priced Report (same invalidation as block_times)
        key = (spec, ver)
        rep = self.sim.cache.get("serving", key, lambda: self.sim.run(spec))
        price = rep.step_time_us / 1e6
        if self.sim.cache.enabled:
            self._price[fast] = price
        return price

    def _raw_hit(self, key: tuple) -> float | None:
        """Pre-bucketing memo on raw (mode, batch, ctx) keys: a fleet trace
        repeats raw shapes millions of times, and even the bucket arithmetic
        + bucketed-key lookup is measurable at that rate."""
        if not self._memos_live():
            return None
        price = self._raw.get(key)
        if price is not None:
            self.lookups += 1
            self.sim.cache.stats["serving"].hits += 1   # semantically a hit
        return price

    def _verify_memo(self, memo: str, key: tuple, price: float,
                     ver=None) -> None:
        """Sanitize-mode cross-check: recompute *key*'s price through the
        authoritative serving-bucket path and require an exact match with
        the memoized value (a mismatch means a memo survived state it
        should not have — a stale-memo leak, caught at runtime)."""
        if memo == "_raw":
            mode, n, length = key
            B = pow2_bucket(n)
            if mode == "decode":
                C = pow2_bucket(length, self.ctx_floor)
                fresh = self._priced_s("decode", B, C, C)
            else:
                S = pow2_bucket(length, self.seq_floor)
                fresh = self._priced_s("prefill", B, S, 0)
        else:
            mode, B, S, cache_len = key
            if ver is None:
                ver = self.sim.engine._state_version()
            spec = self._spec_for(mode, B, S, cache_len)
            rep = self.sim.cache.get("serving", (spec, ver),
                                     lambda: self.sim.run(spec))
            fresh = rep.step_time_us / 1e6
        if fresh != price:
            # analysis/ is ROADMAP queue A item 11: until it is ported,
            # Simulator(sanitize=True) raises, so no oracle reaches this line
            from repro_torch.analysis.sanitize import CacheSanitizerError
            raise CacheSanitizerError(f"oracle.{memo}", key,
                                      repr(price), repr(fresh))

    def decode_step_s(self, batch: int, ctx: int) -> float:
        """One decode iteration: ``batch`` sequences, deepest context ``ctx``."""
        key = ("decode", batch, ctx)
        price = self._raw_hit(key)
        if price is None:
            B = pow2_bucket(batch)
            C = pow2_bucket(ctx, self.ctx_floor)
            price = self._priced_s("decode", B, C, C)
            if self.sim.cache.enabled:
                self._raw[key] = price
        elif self._sanitize:
            self._verify_memo("_raw", key, price)
        return price

    def prefill_s(self, batch: int, seq: int) -> float:
        """One batched prefill of ``batch`` prompts padded to ``seq`` tokens."""
        key = ("prefill", batch, seq)
        price = self._raw_hit(key)
        if price is None:
            B = pow2_bucket(batch)
            S = pow2_bucket(seq, self.seq_floor)
            price = self._priced_s("prefill", B, S, 0)
            if self.sim.cache.enabled:
                self._raw[key] = price
        elif self._sanitize:
            self._verify_memo("_raw", key, price)
        return price

    def mixed_step_s(self, n_decode: int, ctx: int, chunk_tokens: int) -> float:
        """Chunked-prefill iteration: a prompt chunk plus a decode batch.

        Priced as chunk-prefill + decode serialized within the iteration —
        an upper bound (a fused mixed kernel would overlap some of the two),
        conservative in the same direction as the bucket rounding."""
        t = self.prefill_s(1, chunk_tokens)
        if n_decode > 0:
            t += self.decode_step_s(n_decode, ctx)
        return t

    # ------------------------------------------------------------------
    @property
    def n_distinct_steps(self) -> int:
        """Distinct bucketed step specs priced so far — the number of
        potentially-cold full simulations a whole trace boils down to."""
        return len(self._specs)

    def stats(self) -> dict:
        """Cumulative serving-bucket hit/miss counters of the owning sim."""
        return dict(self.sim.cache_stats().get("serving", {}))
