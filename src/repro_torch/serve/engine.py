"""Streaming retrieval serving engine with deadline-aware batching (port of
``repro.serve.engine``).

A stream of (query, deadline, k) requests is admitted through
:class:`repro_torch.dist.fault.DeadlineBatcher` (release on full batch OR
tightest pending deadline), padded into a small set of static shape
buckets (:mod:`repro_torch.serve.bucketing`) and dispatched through one of
the rerank steps of :mod:`repro_torch.retrieval.service`:

* ``dense``  - exact MaxSim over the candidate list (the ``maxsim``
  kernel),
* ``bandit`` - adaptive Col-Bandit reranking (the pooled engine and its
  ``fused_reveal`` kernel; reveal fraction << 1).

Where JAX AOT-compiles one executable per (flavor, token-bucket,
candidate-bucket) key, this engine keeps one *warmed step* per key: the
step callable is built and run once on inputs of the bucket's shape, so
the CUDA kernels it launches are built and loaded and the allocator has
grown before the first request. ``warmup()`` does that for every bucket
the policy can reach; the cache and its build counts are first-class
(``engine.compiled_buckets``, ``metrics.compiles``,
``metrics.compiles_after_warmup``) so tests can assert the no-rebuild
property instead of trusting it.

Requests either carry a stage-1 candidate list (``cand_ids``) or the
engine runs its own stage-1 kNN (``retrieval.pipeline.candidates_for``),
which also yields the Eq. 15 per-cell bounds that make the bandit
effective.

Random draws: a batch's seeds are ``draws.split(draws.fold_in(
draws.key(cfg.seed), batch_ordinal), B)`` and a continuous-mode slot's
seed is ``draws.fold_in(draws.key(cfg.seed), rid)``, the JAX engine's
key derivations on a :class:`repro_torch.core.draws.DrawSource`
(``draws=``, default ``TorchDraws``).

The engine runs on ``device`` (default ``"cuda"``); the tests pass
``"cpu"``, where every kernel takes its plain PyTorch version. The
mesh-resident corpus (``mesh_axes``, ``stage1="local"``), kernel
autotuning and the compile-contract audit are not ported: setting them
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.draws import TORCH_DRAWS, DrawSource
from repro_torch.dist.fault import (ChaosKill, DeadlineBatcher, FaultPlan,
                                    apply_delay)
from repro_torch.kernels.quant import CORPUS_FORMATS
from repro_torch.retrieval.corpus import Corpus, build_corpus
from repro_torch.retrieval.pipeline import candidates_for
from repro_torch.retrieval.service import (init_stream_state,
                                           make_serving_step,
                                           make_streaming_step)
from repro_torch.serve.bucketing import (ShapeBuckets, pad_candidates,
                                         pad_queries, support_bounds)
from repro_torch.serve.resilience import DegradeLadder, Supervisor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static serving configuration (fixes the warmed shape set). Field
    names and defaults are the JAX engine's."""

    batch_size: int = 8
    deadline_s: float = 0.02          # global admission deadline
    token_buckets: Tuple[int, ...] = (8, 16, 32)
    cand_buckets: Tuple[int, ...] = (32, 64)
    max_k: int = 10                   # top-K width (per-request k <=)
    flavor: str = "auto"              # "dense" | "bandit" | "auto"
    bandit_min_candidates: int = 64   # auto: bandit when bucket >= this
    # Col-Bandit knobs (bandit flavor)
    alpha_ef: float = 0.3
    delta: float = 0.01
    block_docs: int = 8
    block_tokens: int = 8
    max_rounds: int = -1
    support: Tuple[float, float] = (0.0, 1.0)
    # Reveal engine for the bandit flavor: "pooled" / "pooled_fused" (one
    # cross-query frontier loop, one fused reveal launch per trip),
    # "pooled_chain" (the chain body, for A/B) or "vmapped" (the lockstep
    # engine).
    bandit_engine: str = "pooled"
    # Pooled engine only: let active queries grow their per-round doc block
    # up to this many docs out of slots freed by retired queries (0 = fixed
    # blocks, exact per-query parity with the solo bandit).
    max_block_docs: int = 0
    # Second growth axis: widen surviving slots' token blocks up to this
    # many tokens per selected doc out of freed frontier cell capacity
    # (0 = fixed token blocks).
    max_block_tokens: int = 0
    # Kernel block-size autotuning: not ported (the port's block sizes are
    # constants of the CUDA sources); True or a table raises.
    autotune: bool = False
    tuning_table: Optional[str] = None
    # Corpus mesh: () serves from one device, the only placement ported; a
    # mesh raises NotImplementedError.
    mesh_axes: Tuple[Tuple[str, int], ...] = ()
    # Resident corpus format (kernels.quant.CORPUS_FORMATS): "bf16" keeps
    # the corpus at its source dtype (f32 stays f32); "int8" and "residual"
    # are compressed, and the kernels dequantize in place. Quantized engines
    # need candidate-carrying requests (stage-1 kNN scans raw token rows).
    corpus_format: str = "bf16"
    # stage-1 kNN (requests without a candidate list)
    stage1_kprime: int = 8
    stage1_candidates: int = 0        # 0 => smallest candidate bucket
    # Stage-1 placement: "host" is the only one ported; "local" (routed,
    # shard-local stage 1) needs a mesh.
    stage1: str = "host"
    # "local" only (inert here, as in JAX off the routed path).
    stage1_centroids: int = 8
    stage1_total: int = 0
    prereveal_ann: bool = False
    # Admission headroom: a request's completion deadline minus the expected
    # batch service time (EMA of observed batches, floored by this) is what
    # the batcher gets, so a deadline-triggered release still has time to
    # execute before the request is due.
    deadline_headroom_s: float = 0.0
    # Async runtime (AsyncRetrievalEngine) knobs, inert on the sync engine.
    # ``pipeline_depth`` bounds the dispatched-but-unharvested batches plus
    # prepared batches queued behind them; 1 is synchronous dispatch.
    pipeline_depth: int = 2
    # Backpressure when a deadline-carrying request's projected completion
    # ((backlog + 1) * expected service) overruns its deadline at submit:
    # "none" admits anyway, "reject" raises AdmissionRejected, "degrade"
    # truncates the candidate list to the smallest candidate bucket and
    # admits (dense and stage-1 requests fall back to plain admission) and
    # arms the fidelity ladder below.
    backpressure: str = "none"
    # Continuous (slot-refill) batching: serve through ONE streaming step
    # instead of batch-at-a-time dispatch; retired slots are refilled from
    # the admission queue mid-flight, and every call advances the live
    # slots ``stream_trip_limit`` trips.
    continuous: bool = False
    stream_trip_limit: int = 4
    # Self-healing runtime: a watchdog (serve.resilience.Supervisor)
    # restarts dead pipeline threads up to ``max_thread_restarts`` each;
    # in-flight work lives on the engine and delivery is rid-deduplicated
    # (zero lost, zero duplicated). Exhaustion escalates to the loud
    # thread-death failure the unsupervised engine raises at once.
    supervise: bool = False
    max_thread_restarts: int = 2
    supervise_interval_s: float = 0.02
    # Deadline-aware fidelity ladder (backpressure="degrade", bandit flavor)
    # as serve.resilience.DegradeLadder: per-call knobs, so changing rungs
    # rebuilds nothing, and rung 0 is bit-identical to no knobs.
    degrade_headrooms: Tuple[float, ...] = (1.0, 0.5, 0.25)
    degrade_alpha_scales: Tuple[float, ...] = (2.0, 4.0, 8.0)
    degrade_round_caps: Tuple[int, ...] = (0, 8, 4)
    seed: int = 0
    # Compile-contract auditing reads XLA HLO and is not ported; True
    # raises. The two bounds only matter with it.
    audit: bool = False
    audit_peak_bytes: int = 0
    audit_require_bf16: bool = False


class AdmissionRejected(RuntimeError):
    """Raised by ``submit`` under ``backpressure="reject"``: the queue is
    deep enough that the request's completion deadline is already
    unmeetable at admission time."""


@dataclasses.dataclass
class Request:
    """One retrieval request: (query, deadline, k)."""

    query: np.ndarray                       # (T, M) float32 token embeddings
    k: int = 10
    deadline_s: Optional[float] = None      # completion deadline (arrival-rel)
    cand_ids: Optional[np.ndarray] = None   # (n,) global doc ids; None=stage-1
    # filled in by the engine
    rid: int = -1
    arrival: float = 0.0
    # Absolute completion deadline (clock frame), stamped once at admission:
    # the one source of truth of the serve-time miss decision.
    deadline_abs: Optional[float] = None
    # Fraction of the request's ORIGINAL candidate list that survived
    # admission (backpressure="degrade" truncation); multiplies into the
    # completion's coverage so a degraded answer is visibly partial.
    coverage_scale: float = 1.0


@dataclasses.dataclass
class Completion:
    rid: int
    topk_ids: np.ndarray          # (k,) global doc ids, -1 padded
    topk_scores: np.ndarray       # (k,) f32
    queue_wait_s: float           # admission latency
    latency_s: float              # arrival -> results on the host
    deadline_miss: bool
    flavor: str
    bucket: Tuple[int, int]       # (token_bucket, cand_bucket)
    reveal_fraction: float        # fraction of MaxSim cells computed
    # Fraction of the request's candidate universe actually searched: 1.0
    # on a full serve, < 1 when admission truncated the candidate list
    # (coverage_scale), 0.0 on an ``error`` completion.
    coverage: float = 1.0
    # Fidelity-ladder rung this request's batch ran at (0 = full fidelity).
    degrade_level: int = 0
    # Loud-failure surface: None on a served completion; the reason when
    # the engine could not serve the request (stopped with work queued and
    # flushing impossible, supervision budget spent, a continuous-mode slot
    # lost to a thread restart). topk_ids are all -1.
    error: Optional[str] = None


@dataclasses.dataclass
class BatchRecord:
    bucket: Tuple[int, int]
    flavor: str
    n_real: int
    occupancy: float              # n_real / batch_size
    service_s: float              # release -> results on the host
    reveal_fraction: float
    # The step's stats vector: live-slot fraction of the pooled frontier
    # (or the lockstep duty cycle), per-query reveal rounds, and the rounds
    # a lockstep loop would have wasted. Dense batches report (1, 0, 0).
    frontier_occupancy: float = 1.0
    total_rounds: float = 0.0
    lockstep_waste: float = 0.0
    # Mesh-resident corpora only (not ported): always None here.
    shard_occupancy: Optional[Tuple[float, ...]] = None
    shard_rounds: Optional[Tuple[float, ...]] = None
    shard_quota_share: Optional[Tuple[float, ...]] = None
    # (doc, query) cells quarantined by the finite-score guard (poisoned
    # corpus rows surfacing NaN/Inf MaxSim values): the step's stats[3].
    quarantined: float = 0.0
    # Fidelity-ladder rung the batch ran at (0 = full fidelity).
    degrade_level: int = 0


class EngineMetrics:
    """Serving metrics: per-request, per-batch, and build accounting.

    Mutations go through the ``record_*`` methods, which take an internal
    lock: the async engine's admit, dispatch and caller threads all write
    here concurrently. ``summary()`` snapshots under the same lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.completions: List[Completion] = []
        self.batches: List[BatchRecord] = []
        self.compiles: Dict[tuple, int] = {}
        self.compiles_after_warmup: int = 0
        # Backpressure accounting (async engine): requests refused outright
        # and requests admitted with a truncated candidate list.
        self.rejected: int = 0
        self.degraded: int = 0
        # Autotuning and mesh accounting: not ported, kept at their idle
        # values so the summary has the JAX engine's keys.
        self.autotune_s: float = 0.0
        self.autotune_buckets: int = 0
        self.tuning_entries_loaded: int = 0
        self.failovers: int = 0
        self.shard_health: Optional[List[bool]] = None
        # Serving threads restarted by the supervision watchdog.
        self.thread_restarts: Dict[str, int] = {}

    def record_compile(self, key: tuple, after_warmup: bool) -> None:
        with self._lock:
            self.compiles[key] = self.compiles.get(key, 0) + 1
            if after_warmup:
                self.compiles_after_warmup += 1

    def record_batch(self, record: BatchRecord,
                     completions: Sequence[Completion]) -> None:
        with self._lock:
            self.batches.append(record)
            self.completions.extend(completions)

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_degraded(self) -> None:
        with self._lock:
            self.degraded += 1

    def record_restart(self, name: str) -> None:
        with self._lock:
            self.thread_restarts[name] = self.thread_restarts.get(name, 0) + 1

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            reqs, bats = list(self.completions), list(self.batches)
            n_compiles = int(sum(self.compiles.values()))
            n_after = int(self.compiles_after_warmup)
            n_rej, n_deg = self.rejected, self.degraded
            n_fail = self.failovers
            health = (None if self.shard_health is None
                      else list(self.shard_health))
            restarts = dict(self.thread_restarts)
        bandit_bats = [b for b in bats if b.flavor == "bandit"]
        waits = np.array([c.queue_wait_s for c in reqs] or [0.0])
        lats = np.array([c.latency_s for c in reqs] or [0.0])
        return {
            "n_requests": len(reqs),
            "n_batches": len(bats),
            "queue_wait_p50_ms": float(np.percentile(waits, 50) * 1e3),
            "queue_wait_p99_ms": float(np.percentile(waits, 99) * 1e3),
            "latency_p50_ms": float(np.percentile(lats, 50) * 1e3),
            "latency_p99_ms": float(np.percentile(lats, 99) * 1e3),
            "deadline_miss_rate": (float(np.mean([c.deadline_miss
                                                  for c in reqs]))
                                   if reqs else 0.0),
            "mean_occupancy": (float(np.mean([b.occupancy for b in bats]))
                               if bats else 0.0),
            "mean_reveal_fraction": (float(np.mean([b.reveal_fraction
                                                    for b in bats]))
                                     if bats else 0.0),
            # Bandit batches only: dense batches report a placeholder 1.0
            # that would dilute the frontier diagnostic under mixed traffic.
            "mean_frontier_occupancy": (float(np.mean(
                [b.frontier_occupancy for b in bandit_bats]))
                if bandit_bats else 0.0),
            "total_reveal_rounds": float(sum(b.total_rounds for b in bats)),
            "total_lockstep_waste": float(sum(b.lockstep_waste
                                              for b in bats)),
            "compiles": n_compiles,
            "compiles_after_warmup": n_after,
            "rejected": int(n_rej),
            "degraded": int(n_deg),
            "autotune_s": float(self.autotune_s),
            "autotune_buckets": int(self.autotune_buckets),
            "tuning_entries_loaded": int(self.tuning_entries_loaded),
            # Resilience surface: quarantined poisoned cells, mean answer
            # coverage (served completions only), ladder activity,
            # failovers, shard health (mesh only) and watchdog restarts.
            "quarantined_total": float(sum(b.quarantined for b in bats)),
            "mean_coverage": (float(np.mean([c.coverage for c in reqs
                                             if c.error is None] or [1.0]))),
            "errors": int(sum(1 for c in reqs if c.error is not None)),
            "ladder_degraded_batches": int(sum(1 for b in bats
                                               if b.degrade_level > 0)),
            "failovers": int(n_fail),
            **({"shard_healthy": health} if health is not None else {}),
            "thread_restarts": restarts,
        }


class _Prepared(NamedTuple):
    """A released batch after host-side preparation (bucketing, padding,
    stage 1): everything the dispatch thread needs to launch the step and
    the harvest needs to attribute results."""

    real: List[Request]
    n_real: int
    bucket: Tuple[int, int]
    flavor: str
    exe: Any
    args: tuple
    t_release: float
    # Batch ordinal: the idempotency key the supervised dispatch path uses
    # to harvest a batch exactly once across thread restarts.
    bid: int = -1
    degrade_level: int = 0


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 "
        f"item {item})")


class RetrievalEngine:
    """Deadline-batched, shape-bucketed late-interaction serving loop.

    Typical use::

        engine = RetrievalEngine(doc_embs, doc_mask, EngineConfig(...))
        engine.warmup()                        # build + run every bucket
        rid = engine.submit(Request(query=q, k=5, deadline_s=0.05))
        done = engine.poll()                   # [] until a batch releases
        done += engine.drain()                 # end of stream: flush queue

    ``clock`` is injectable so tests and simulations drive virtual time;
    ``device`` is where the corpus lives and the steps run (``"cuda"`` by
    default); ``draws`` is the ``DrawSource`` of the bandit's seeds.

    Batch execution is staged as prepare (host: bucket, pad, stage 1) ->
    dispatch (call the bucket's step; the dense step returns device tensors
    without waiting, the bandit step returns when its host-driven trip loop
    has finished) -> finish (copy to the host + attribution). This engine
    runs the three back to back per batch, the synchronous parity oracle;
    :class:`AsyncRetrievalEngine` runs them on a pipeline.
    """

    def __init__(self, corpus_embs, corpus_mask,
                 config: Optional[EngineConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda", draws: Optional[DrawSource] = None):
        self.cfg = config or EngineConfig()
        self.clock = clock
        cfg = self.cfg
        if cfg.stage1 not in ("host", "local"):
            raise ValueError(f"unknown stage1 placement {cfg.stage1!r} "
                             "(expected 'host' or 'local')")
        if cfg.corpus_format not in CORPUS_FORMATS:
            raise ValueError(
                f"unknown corpus_format {cfg.corpus_format!r} "
                f"(expected one of {sorted(CORPUS_FORMATS)})")
        self._quantized = cfg.corpus_format != "bf16"
        if self._quantized and cfg.stage1 == "local":
            raise ValueError(
                "stage1='local' routes candidates by scanning raw corpus "
                "token rows inside the shard_map and cannot serve a "
                f"{cfg.corpus_format!r} corpus; use stage1='host' "
                "with candidate-carrying requests")
        if cfg.mesh_axes:
            raise _not_ported("a mesh-resident corpus (mesh_axes, "
                              "stage1='local', shard failover)", "4")
        if cfg.stage1 == "local":
            raise ValueError("stage1='local' runs inside the corpus "
                             "shard_map and needs mesh_axes")
        if cfg.autotune or cfg.tuning_table:
            raise _not_ported("kernel autotuning (autotune, tuning_table)",
                              "3")
        if cfg.audit:
            raise _not_ported("the compile-contract audit (audit)", "5")
        self.device = torch.device(device)
        self._draws = draws or TORCH_DRAWS
        self.corpus: Corpus = build_corpus(
            corpus_embs, corpus_mask, router_seed=cfg.seed,
            corpus_format=cfg.corpus_format, device=self.device)
        self.corpus_embs = self.corpus.embs
        self.corpus_mask = self.corpus.mask
        self.buckets = ShapeBuckets(cfg.token_buckets, cfg.cand_buckets)
        self._stage1_n = self.buckets.cand_bucket(
            cfg.stage1_candidates or self.buckets.cand_buckets[0])
        self._service_ema = 0.0           # observed batch service time (s)
        # Admission headroom is a LIVE callable: the batcher derives each
        # deadline-carrying request's admission deadline as
        # ``deadline_abs - headroom()`` at poll time.
        self._batcher = DeadlineBatcher(cfg.batch_size, cfg.deadline_s,
                                        clock=clock,
                                        headroom=self._admission_headroom)
        self._exec: Dict[tuple, Any] = {}
        # Build-once across threads (the admit thread builds stage 1 on a
        # cold miss while the dispatch thread builds a step, etc.).
        self._exec_lock = threading.RLock()
        self._state_lock = threading.Lock()      # guards _service_ema
        self._rid = itertools.count()
        # Batch ORDINAL, folded into the draws of key(cfg.seed): every
        # batch reveals a distinct trajectory and the whole stream replays
        # bit-identically from the same config.
        self._batch_seed = itertools.count()
        self._bid = itertools.count()            # _Prepared idempotency key
        self._base_seed = self._draws.key(cfg.seed, self.device)
        self._warmed = False
        self.metrics = EngineMetrics()
        # Fidelity ladder (validated eagerly even when backpressure is not
        # "degrade", so a bad config fails at construction).
        self._ladder = DegradeLadder(
            headrooms=tuple(cfg.degrade_headrooms),
            alpha_scales=tuple(cfg.degrade_alpha_scales),
            round_caps=tuple(cfg.degrade_round_caps))

    def _admission_headroom(self) -> float:
        """Expected batch service time the batcher must leave between
        admission and the completion deadline: the LIVE estimate, floored
        by the configured static headroom."""
        with self._state_lock:
            return max(self.cfg.deadline_headroom_s, self._service_ema)

    # -- shard health (mesh engines only, not ported) ----------------------

    def shard_health(self) -> Optional[np.ndarray]:
        """The per-shard health mask: None on a single-device engine."""
        return None

    def set_shard_health(self, shard: int, healthy: bool) -> None:
        raise ValueError("shard health needs a mesh-resident corpus "
                         "(set mesh_axes)")

    def fail_shard(self, shard: int) -> None:
        self.set_shard_health(shard, False)

    def restore_shard(self, shard: int) -> None:
        self.set_shard_health(shard, True)

    # -- flavor policy ----------------------------------------------------

    def flavor_for(self, cand_bucket: int) -> str:
        """Dense-vs-bandit dispatch: fixed flavor, or (auto) adaptive
        reranking once the candidate bucket is large enough for the bandit's
        sublinear reveal count to beat dense scoring's fixed N*T cost."""
        if self.cfg.flavor in ("dense", "bandit"):
            return self.cfg.flavor
        if self.cfg.flavor != "auto":
            raise ValueError(f"unknown flavor {self.cfg.flavor!r}")
        return ("bandit" if cand_bucket >= self.cfg.bandit_min_candidates
                else "dense")

    # -- warmed-step cache --------------------------------------------------

    @property
    def compiled_buckets(self) -> List[tuple]:
        return sorted(self._exec)

    def _executable(self, key: tuple):
        """One warmed step per bucket key; builds (and counts) on a miss.
        Thread-safe: a cold miss builds under the cache lock, so two
        threads racing the same key produce one build."""
        exe = self._exec.get(key)
        if exe is not None:
            return exe
        with self._exec_lock:
            return self._compile(key)

    def _compile(self, key: tuple):
        with self._exec_lock:
            exe = self._exec.get(key)
            if exe is not None:
                return exe
            exe = self._build(key)
            self._exec[key] = exe
        self.metrics.record_compile(key, after_warmup=self._warmed)
        return exe

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _warm_inputs(self, tb: int, nb: int):
        """A (B, tb) query batch and (B, nb) candidates with their generic
        bounds, as host numpy, for a bucket's warm run: seeded unit query
        rows and the first nb doc ids (cycled over a small corpus)."""
        B = self.cfg.batch_size
        M = self.corpus_embs.shape[2]
        q = np.random.default_rng(0).standard_normal((B, tb, M))
        q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
        cand = np.tile(np.arange(nb, dtype=np.int32) % self.corpus.n_docs,
                       (B, 1))
        a, b = support_bounds(cand, [tb] * B, tb, self.cfg.support)
        return q, cand, a, b

    def _build(self, key: tuple):
        """Build the step of one bucket key and run it once on inputs of
        the bucket's shape, so its kernels are built and loaded before
        traffic (no cache interaction: ``_compile`` owns the cache)."""
        cfg = self.cfg
        B = cfg.batch_size
        step_kw = dict(topk=cfg.max_k, alpha_ef=cfg.alpha_ef,
                       delta=cfg.delta, block_docs=cfg.block_docs,
                       block_tokens=cfg.block_tokens,
                       max_rounds=cfg.max_rounds,
                       max_block_docs=cfg.max_block_docs,
                       max_block_tokens=cfg.max_block_tokens)
        draws, base = self._draws, self._base_seed
        if key[0] == "step":
            _, flavor, tb, nb = key
            step = make_serving_step(flavor, engine=cfg.bandit_engine,
                                     draws=draws, **step_kw)

            def run(ce, cm, q, cand, a, b, ordinal, a_s, r_c):
                # Per-batch draws: fold the batch ordinal into the
                # engine-seed stream (never seed + ordinal, which aliases
                # across engines with nearby seeds). Dense draws nothing.
                seeds = (None if flavor == "dense" else
                         draws.split(draws.fold_in(base, ordinal), B))
                return step(ce, cm, q, cand, a, b, seeds, alpha_scale=a_s,
                            round_cap=r_c)

            q, cand, a, b = self._warm_inputs(tb, nb)
            # One capped round: enough to launch every kernel of the step.
            warm = run(self.corpus_embs, self.corpus_mask, self._tensor(q),
                       self._tensor(cand), self._tensor(a), self._tensor(b),
                       0, 1.0, 1)
        elif key[0] == "stream":
            _, tb, nb = key
            run = make_streaming_step(trip_limit=cfg.stream_trip_limit,
                                      draws=draws, **step_kw)
            q, cand, a, b = self._warm_inputs(tb, nb)
            warm = run(self.corpus_embs, self.corpus_mask, self._tensor(q),
                       self._tensor(cand), self._tensor(a), self._tensor(b),
                       init_stream_state(B, nb, tb, device=self.device),
                       torch.ones((B,), dtype=torch.bool,
                                  device=self.device),
                       draws.split(base, B))[:5]
        elif key[0] == "stage1":
            _, tb = key
            if self._quantized:
                raise ValueError(
                    "stage-1 kNN needs a dense corpus; quantized engines "
                    "serve candidate-carrying requests only")
            kw = dict(kprime=cfg.stage1_kprime,
                      max_candidates=self._stage1_n, support=cfg.support)

            def run(ce, cm, q):
                cs = candidates_for(ce, cm, q, **kw)
                return cs.doc_ids, cs.a, cs.b

            warm = run(self.corpus_embs, self.corpus_mask,
                       self._tensor(self._warm_inputs(tb, 1)[0]))
        else:
            raise KeyError(key)
        for x in warm:
            x.cpu()
        return run

    def warmup(self) -> List[tuple]:
        """Build and run once every bucket the policy can reach; after this
        returns the engine serves any admissible stream with zero builds,
        and no serving thread ever compiles a kernel."""
        for tb in self.buckets.token_buckets:
            if not self._quantized:
                # Stage 1 scans raw token rows; quantized engines reject
                # candidate-less requests at submit, so the bucket is
                # unreachable there.
                self._executable(("stage1", tb))
            for nb in self.buckets.cand_buckets:
                # flavor_for is a pure function of the bucket, so exactly
                # one flavor is reachable per (tb, nb).
                self._executable(("step", self.flavor_for(nb), tb, nb))
        if self.cfg.continuous:
            self._executable(("stream", *self._stream_bucket))
        self._warmed = True
        return self.compiled_buckets

    @property
    def _stream_bucket(self) -> Tuple[int, int]:
        """Continuous mode serves every request through ONE shape: the
        largest token bucket x the largest candidate bucket (any admissible
        request pads into it, so refill never rebuilds)."""
        return (self.buckets.token_buckets[-1],
                max(self.buckets.cand_buckets[-1], self._stage1_n))

    # -- request lifecycle ------------------------------------------------

    def submit(self, request: Request) -> int:
        """Admit one request; returns its rid. Completions surface from
        ``poll``/``drain`` (requests are served strictly in batches).
        The caller's Request is not mutated: the engine queues its own
        copy, so one Request object may be submitted repeatedly."""
        M = self.corpus_embs.shape[2]
        q = np.asarray(request.query, np.float32)
        if q.ndim != 2 or q.shape[1] != M:
            raise ValueError(f"query must be (T, {M})")
        self.buckets.token_bucket(q.shape[0])          # validate fit
        if request.cand_ids is None and self._quantized:
            raise ValueError(
                "candidate-less requests need the engine's stage-1 kNN, "
                f"which a {self.cfg.corpus_format!r} corpus cannot run - "
                "provide cand_ids or serve with corpus_format='bf16'")
        if request.cand_ids is not None:
            self.buckets.cand_bucket(len(request.cand_ids))
            cand = np.asarray(request.cand_ids)
            n_docs = self.corpus.n_docs
            if cand.size and (cand.min() < 0 or cand.max() >= n_docs):
                # Reject the one bad request HERE: a bad id surfacing later
                # would fail mid-batch and take every batchmate down.
                raise ValueError(
                    f"cand_ids must lie in [0, {n_docs}); got range "
                    f"[{int(cand.min())}, {int(cand.max())}]")
        if request.k > self.cfg.max_k:
            raise ValueError(f"k={request.k} > max_k={self.cfg.max_k}")
        arrival = self.clock()
        admitted = dataclasses.replace(
            request, query=q, rid=next(self._rid), arrival=arrival,
            deadline_abs=(None if request.deadline_s is None
                          else arrival + request.deadline_s))
        self._enqueue(admitted)
        return admitted.rid

    def _enqueue(self, admitted: Request) -> None:
        """Queue placement for a validated request (the async engine's
        continuous mode overrides this to feed the slot-refill stream)."""
        self._batcher.add(admitted, deadline_abs=admitted.deadline_abs)

    def next_expiry(self) -> Optional[float]:
        """Absolute clock time at which the pending (partial) batch will be
        released; None when the queue is empty."""
        return self._batcher.next_expiry()

    def poll(self) -> List[Completion]:
        """Serve at most one released batch; [] while the admission queue is
        neither full nor past its tightest deadline."""
        out = self._batcher.poll()
        if out is None:
            return []
        return self._serve_batch(*out)

    def drain(self) -> List[Completion]:
        """End of stream: serve every full batch, then flush the remainder
        (flush releases at most one padded batch per call)."""
        done: List[Completion] = []
        while True:
            out = self._batcher.poll()
            if out is None:
                break
            done.extend(self._serve_batch(*out))
        while True:
            out = self._batcher.flush()
            if out is None:
                break
            done.extend(self._serve_batch(*out))
        return done

    # -- batch execution --------------------------------------------------

    def _serve_batch(self, reqs: Sequence[Request],
                     n_real: int) -> List[Completion]:
        """Synchronous path: prepare, dispatch, and harvest back to back."""
        prep = self._prepare_batch(reqs, n_real, self.clock())
        return self._finish_batch(prep, self._dispatch_batch(prep))

    def _dispatch_batch(self, prep: _Prepared):
        """Call the batch's step. The dense step returns device tensors
        without waiting; the bandit step's trip loop reads the device every
        trip, so it returns when the batch is done."""
        return prep.exe(*prep.args)

    def _degrade_level(self, real: Sequence[Request], flavor: str) -> int:
        """Fidelity-ladder rung for this batch: 0 unless the degrade
        policy is on, the batch has fidelity to trade (bandit flavor on a
        knob-aware reveal engine), and the tightest deadline's headroom
        ratio has fallen below the ladder thresholds."""
        cfg = self.cfg
        if (cfg.backpressure != "degrade" or flavor != "bandit"
                or cfg.bandit_engine == "vmapped"):
            return 0
        deadlines = [r.deadline_abs for r in real
                     if r.deadline_abs is not None]
        expected = self._admission_headroom()
        if not deadlines or expected <= 0:
            return 0
        ratio = (min(deadlines) - self.clock()) / expected
        return self._ladder.level_for(ratio)

    def _stage1(self, tb: int, queries: np.ndarray):
        """Stage-1 candidate ids and Eq. 15 bounds of (n, tb, M) host
        queries, as host numpy. Each query's candidates depend on it alone,
        so only the rows that need them are computed."""
        out = self._executable(("stage1", tb))(
            self.corpus_embs, self.corpus_mask, self._tensor(queries))
        return tuple(x.cpu().numpy() for x in out)

    def _prepare_batch(self, reqs: Sequence[Request], n_real: int,
                       t_release: float) -> _Prepared:
        """Host-side batch assembly: bucket, pad, stage 1 - no waiting on
        the main step."""
        cfg = self.cfg
        real = list(reqs[:n_real])
        tb = self.buckets.token_bucket(max(r.query.shape[0] for r in real))
        provided = [r.cand_ids for r in reqs]
        missing = [c is None for c in provided]
        n_need = max([len(c) for c in provided if c is not None], default=0)
        if any(missing):
            n_need = max(n_need, self._stage1_n)
        nb = self.buckets.cand_bucket(max(n_need, 1))

        queries = pad_queries([r.query for r in reqs], tb)
        cand = pad_candidates(provided, nb)
        n_toks = [r.query.shape[0] for r in reqs]
        a, b = support_bounds(cand, n_toks, tb, cfg.support)

        if any(missing):
            rows = np.flatnonzero(missing)
            ids1, a1, b1 = self._stage1(tb, queries[rows])
            n1 = self._stage1_n
            for j, i in enumerate(rows):
                cand[i, :n1], cand[i, n1:] = ids1[j], -1
                a[i, :n1], a[i, n1:] = a1[j], 0.0
                b[i, :n1], b[i, n1:] = b1[j], 0.0

        flavor = self.flavor_for(nb)
        exe = self._executable(("step", flavor, tb, nb))
        ordinal = next(self._batch_seed)
        level = self._degrade_level(real, flavor)
        a_s, r_c = self._ladder.knobs(level)
        args = (self.corpus_embs, self.corpus_mask, self._tensor(queries),
                self._tensor(cand), self._tensor(a), self._tensor(b),
                ordinal, a_s, r_c)
        return _Prepared(real, n_real, (tb, nb), flavor, exe, args,
                         t_release, next(self._bid), level)

    def _finish_batch(self, prep: _Prepared, out) -> List[Completion]:
        """Completion harvest: copies the step's outputs to the host (the
        wait on the device) and attributes them."""
        cfg = self.cfg
        real, n_real = prep.real, prep.n_real
        bucket, flavor, t_release = prep.bucket, prep.flavor, prep.t_release
        scores, gids, frac, stats = (x.cpu().numpy() for x in out)
        t_done = self.clock()

        service_s = t_done - t_release
        with self._state_lock:
            self._service_ema = (service_s if not self.metrics.batches
                                 else 0.7 * self._service_ema
                                 + 0.3 * service_s)
        record = BatchRecord(
            bucket=bucket, flavor=flavor, n_real=n_real,
            occupancy=n_real / cfg.batch_size,
            service_s=service_s,
            reveal_fraction=float(np.mean(frac[:n_real])),
            frontier_occupancy=float(stats[0]),
            total_rounds=float(stats[1]),
            lockstep_waste=float(stats[2]),
            quarantined=float(stats[3]),
            degrade_level=prep.degrade_level)

        done: List[Completion] = []
        for i, r in enumerate(real):
            done.append(Completion(
                rid=r.rid,
                topk_ids=gids[i, :r.k].copy(),
                topk_scores=scores[i, :r.k].copy(),
                queue_wait_s=t_release - r.arrival,
                latency_s=t_done - r.arrival,
                # Serve-time stamping against the ABSOLUTE deadline captured
                # at admission, however the request reached this batch.
                deadline_miss=(r.deadline_abs is not None
                               and t_done > r.deadline_abs + 1e-9),
                flavor=flavor, bucket=bucket,
                reveal_fraction=float(frac[i]),
                coverage=r.coverage_scale,
                degrade_level=prep.degrade_level))
        self.metrics.record_batch(record, done)
        return done


# Dispatch-queue sentinel: the admit thread pushes it when it exits so the
# dispatch thread drains its in-flight batches and terminates.
_STOP = object()


# -- static thread-safety contract (the JAX package's analysis.locks) --------
# One attribute-access set per thread type is rooted at these methods; any
# attribute shared by >= 2 thread types must be in GUARDED_BY or be
# consistently accessed under one ``with self.<lock>:``.
THREAD_ENTRY_POINTS = {
    "caller": ("submit", "poll", "drain", "stop", "start", "warmup",
               "future", "next_expiry", "set_shard_health", "fail_shard",
               "restore_shard", "shard_health"),
    "admit": ("_admit_loop", "_guard"),
    "dispatch": ("_dispatch_loop", "_guard"),
    "stream": ("_stream_loop", "_guard"),
    "supervisor": ("_pre_restart", "_supervision_exhausted", "_spawn"),
}

# Attribute -> its guard. A lock name ("_done_cv", "_exec_lock", ...) means
# every write outside __init__ sits under ``with self.<lock>``. The mode
# strings document guards a lexical check cannot see:
#   internal - the object locks itself (DeadlineBatcher, EngineMetrics);
#   atomic   - single CPython-atomic pointer swap, readers tolerate either
#              value (the supervisor handle);
#   ordered  - writes happen-before the reading thread starts (start()'s
#              thread bookkeeping, supervisor-callback state mutated only
#              while the watched thread is dead) or after it joins;
#   init     - written once before any serving thread exists (warmup flag).
GUARDED_BY = {
    "_futures": "_done_cv",
    "_submitted": "_done_cv",
    "_finished": "_done_cv",
    "_thread_exc": "_done_cv",
    "_completed": "_completed_lock",
    "_delivered_rids": "_completed_lock",
    "_disp_inflight": "_inflight_lock",
    "_inflight": "_inflight_lock",
    "_stream_q": "_work_cv",
    "_service_ema": "_state_lock",
    "_exec": "_exec_lock",
    "_batcher": "internal",
    "_supervisor": "atomic",
    "_admit_holding": "ordered",
    "_harvested": "ordered",
    "_stream_slots": "ordered",
    "_targets": "ordered",
    "_thread_by_name": "ordered",
    "_threads": "ordered",
    "_started": "ordered",
    "_warmed": "init",
}


class AsyncRetrievalEngine(RetrievalEngine):
    """Async continuous-serving runtime over the same warmed buckets.

    Two dedicated threads split the synchronous engine's serve loop:

    * the ADMIT thread drives the deadline batcher (sleeping toward
      ``next_expiry``, which wakes at once on a ready full batch) and runs
      host-side batch preparation (bucketing, padding, stage 1);
    * the DISPATCH thread calls prepared batches' steps and harvests them
      once the pipeline holds ``cfg.pipeline_depth`` batches (or goes
      idle). A dense step returns before its kernels finish, so batch i+1
      dispatches while i executes; a bandit step runs its trip loop on the
      dispatch thread and returns finished, so what overlaps then is the
      admit thread's preparation of the next batch.

    Both threads share the device's default stream, so their device work
    runs in the order it is enqueued; ``warmup()`` builds every kernel
    library before ``start()``.

    Admission backpressure (``cfg.backpressure``) rejects or degrades a
    deadline-carrying request at ``submit`` when the projected completion
    (queue backlog plus pipeline depth, costed at the live service-time
    EMA) already overruns its deadline.

    With ``cfg.continuous`` the batch pipeline is replaced by slot-level
    continuous batching: ONE streaming step
    (``retrieval.service.make_streaming_step``) holds a ``batch_size``-slot
    frontier; every call advances all live slots ``cfg.stream_trip_limit``
    trips, and slots whose query retired are harvested and refilled from
    the admission queue mid-flight.

    Completions surface three ways: ``poll()`` (non-blocking pop of
    everything finished since the last poll), ``drain()`` (block until all
    submitted work completes), and per-request ``future(rid)``. An
    un-``start()``-ed async engine serves exactly like
    :class:`RetrievalEngine`.
    """

    def __init__(self, corpus_embs, corpus_mask,
                 config: Optional[EngineConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda", draws: Optional[DrawSource] = None,
                 poll_interval_s: float = 0.002,
                 fault_plan: Optional[FaultPlan] = None):
        super().__init__(corpus_embs, corpus_mask, config, clock=clock,
                         device=device, draws=draws)
        if self.cfg.backpressure not in ("none", "reject", "degrade"):
            raise ValueError(f"unknown backpressure policy "
                             f"{self.cfg.backpressure!r}")
        if self.cfg.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self._poll_interval = float(poll_interval_s)
        self._work_cv = threading.Condition()
        self._done_cv = threading.Condition()
        self._stop_evt = threading.Event()
        self._drain_evt = threading.Event()
        self._prep_q: queue_mod.Queue = queue_mod.Queue(
            maxsize=self.cfg.pipeline_depth)
        self._completed_lock = threading.Lock()
        self._completed: deque = deque()
        self._futures: Dict[int, Future] = {}
        self._submitted = 0
        self._finished = 0
        self._inflight = 0
        self._stream_q: deque = deque()
        self._threads: List[threading.Thread] = []
        self._thread_exc: Optional[BaseException] = None
        self._started = False
        # Fault-injection harness: an empty plan adds nothing to the
        # serving loops (the chaos hook returns before ticking).
        self._fault_plan = (fault_plan if fault_plan is not None
                            and not fault_plan.empty else None)
        # Supervised-restart state. Every piece of in-flight pipeline work
        # lives on the ENGINE so a restarted thread resumes it: the batch
        # the admit thread is offering to a full dispatch queue
        # (_admit_holding), the dispatched-batch deque (_disp_inflight),
        # and the continuous stream's occupied slots (_stream_slots).
        # Harvest idempotency comes from _harvested (batch bids finished)
        # plus rid-dedup at delivery (_delivered_rids): together they give
        # the zero-lost / zero-duplicated completion guarantee.
        self._supervisor: Optional[Supervisor] = None
        self._targets: Dict[str, Callable[[], None]] = {}
        self._thread_by_name: Dict[str, threading.Thread] = {}
        self._inflight_lock = threading.Lock()
        self._disp_inflight: deque = deque()
        self._admit_holding: Optional[_Prepared] = None
        self._harvested: set = set()
        self._delivered_rids: set = set()
        self._stream_slots: List[Optional[Request]] = []

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "AsyncRetrievalEngine":
        """Spawn the serving threads (plus the supervision watchdog under
        ``cfg.supervise``). Idempotent while running."""
        if self._started:
            return self
        self._raise_if_failed()
        self._stop_evt.clear()
        if self.cfg.continuous:
            self._targets = {"repro-stream": self._stream_loop}
        else:
            self._targets = {"repro-admit": self._admit_loop,
                             "repro-dispatch": self._dispatch_loop}
        self._thread_by_name = {}
        self._started = True
        if self.cfg.supervise:
            self._supervisor = Supervisor(
                max_restarts=self.cfg.max_thread_restarts,
                interval_s=self.cfg.supervise_interval_s,
                stopping=self._stop_evt.is_set,
                on_exhausted=self._supervision_exhausted)
        for name in self._targets:
            t = self._spawn(name)
            if self._supervisor is not None:
                self._supervisor.watch(
                    name, t, factory=functools.partial(self._spawn, name),
                    on_restart=functools.partial(self._pre_restart, name))
        self._threads = list(self._thread_by_name.values())
        if self._supervisor is not None:
            self._supervisor.start()
        return self

    def _spawn(self, name: str) -> threading.Thread:
        """Build AND start one named serving thread: the initial spawn and
        the supervisor's restart factory."""
        t = threading.Thread(target=self._guard,
                             args=(self._targets[name], name), name=name,
                             daemon=True)
        self._thread_by_name[name] = t
        t.start()
        return t

    def _pre_restart(self, name: str) -> None:
        """Watchdog callback just before a dead thread is replaced."""
        self.metrics.record_restart(name)
        if name == "repro-stream":
            # The stream loop's frontier state died with its thread: the
            # occupied slots' bandit progress is unrecoverable, so fail
            # those requests LOUDLY (queued requests replay fine: the fresh
            # thread refills from the intact admission queue).
            self._fail_stream_slots(
                "continuous-stream thread restarted; in-flight slot lost")

    def _supervision_exhausted(self, name: str,
                               exc: Optional[BaseException]) -> None:
        """Restart budget spent: escalate to the unsupervised engine's
        loud thread-death failure."""
        with self._done_cv:
            self._thread_exc = exc if exc is not None else RuntimeError(
                f"{name} died with its restart budget exhausted")
            self._stop_evt.set()
            self._done_cv.notify_all()

    def stop(self) -> None:
        """Stop the serving threads, then FLUSH: every admitted request is
        completed (queued and in-flight batches are served synchronously)
        or, when serving is impossible (e.g. a dead thread), failed loudly
        with an ``error`` completion. Nothing is silently dropped and no
        future dangles after stop."""
        if not self._started:
            return
        self._stop_evt.set()
        if self._supervisor is not None:
            self._supervisor.stop()
            self._supervisor = None
        with self._work_cv:
            self._work_cv.notify_all()
        for t in list(self._thread_by_name.values()):
            t.join(timeout=60.0)
        self._started = False
        if self._thread_exc is None:
            self._shutdown_flush()
        self._fail_pending("engine stopped before serving this request")
        self._raise_if_failed()

    def __enter__(self) -> "AsyncRetrievalEngine":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def _guard(self, fn, name: str = "") -> None:
        try:
            fn()
        except BaseException as e:
            if self._supervisor is not None and not self._stop_evt.is_set():
                # Supervised: die quietly; the watchdog restarts within
                # budget or escalates through _supervision_exhausted.
                self._supervisor.note_failure(name, e)
                return
            # Unsupervised (or stopping): propagate to drain()/stop().
            with self._done_cv:
                self._thread_exc = e
                self._stop_evt.set()
                self._done_cv.notify_all()

    def _raise_if_failed(self) -> None:
        with self._done_cv:
            exc, self._thread_exc = self._thread_exc, None
        if exc is not None:
            raise RuntimeError("serving thread died") from exc

    # -- fault injection ---------------------------------------------------

    def _chaos(self, point: str) -> None:
        """Tick the fault plan's chaos point (once per thread-loop
        iteration). Kills raise AFTER state flips apply, matching
        FaultPlan.tick's ordering."""
        plan = self._fault_plan
        if plan is None:
            return
        for f in plan.tick(point):
            if f.action == "kill":
                raise ChaosKill(f"injected kill at {point!r} "
                                f"tick {f.at}")
            if f.action == "shard_down":
                self.fail_shard(int(f.arg))
            elif f.action == "shard_up":
                self.restore_shard(int(f.arg))
            elif f.action == "delay":
                apply_delay(self.clock, float(f.arg))

    # -- admission --------------------------------------------------------

    def _backlog_batches(self) -> int:
        """Batches queued ahead of a request admitted right now."""
        B = self.cfg.batch_size
        if self.cfg.continuous:
            with self._work_cv:
                return (len(self._stream_q) + B - 1) // B
        queued = (len(self._batcher) + B - 1) // B
        with self._inflight_lock:
            inflight = self._inflight
        return queued + self._prep_q.qsize() + inflight

    def submit(self, request: Request) -> int:
        if self.cfg.continuous and not self._started:
            raise RuntimeError("continuous mode serves from the stream "
                               "thread; call start() before submit()")
        self._raise_if_failed()
        cfg = self.cfg
        if cfg.backpressure != "none" and request.deadline_s is not None:
            # Projected completion: every batch ahead of this request plus
            # its own, costed at the live expected batch service time.
            expected = self._admission_headroom()
            wait = (self._backlog_batches() + 1) * expected
            if wait > request.deadline_s:
                if cfg.backpressure == "reject":
                    self.metrics.record_rejected()
                    raise AdmissionRejected(
                        f"projected wait {wait * 1e3:.1f} ms exceeds "
                        f"deadline {request.deadline_s * 1e3:.1f} ms")
                min_nb = self.buckets.cand_buckets[0]
                if (request.cand_ids is not None
                        and len(request.cand_ids) > min_nb):
                    # First ladder rung: truncate to the cheapest warmed
                    # candidate bucket; the lost tail is a visible coverage
                    # deficit on the completion, not a silent downgrade.
                    request = dataclasses.replace(
                        request,
                        cand_ids=np.asarray(request.cand_ids)[:min_nb],
                        coverage_scale=(request.coverage_scale
                                        * min_nb / len(request.cand_ids)))
                    self.metrics.record_degraded()
        return super().submit(request)

    def _enqueue(self, admitted: Request) -> None:
        with self._done_cv:
            self._futures[admitted.rid] = Future()
            self._submitted += 1
        if self.cfg.continuous:
            with self._work_cv:
                self._stream_q.append(admitted)
                self._work_cv.notify_all()
        else:
            super()._enqueue(admitted)
            with self._work_cv:
                self._work_cv.notify_all()

    def future(self, rid: int) -> Optional[Future]:
        """The request's completion future (None for unknown rids)."""
        with self._done_cv:
            return self._futures.get(rid)

    # -- completion surfaces ----------------------------------------------

    def _resolve(self, comps: Sequence[Completion]) -> None:
        if not comps:
            return
        with self._done_cv:
            for c in comps:
                fut = self._futures.get(c.rid)
                if fut is not None and not fut.done():
                    fut.set_result(c)
                self._finished += 1
            self._done_cv.notify_all()

    def _deliver(self, comps: Sequence[Completion]) -> None:
        """Idempotent completion delivery: a rid is surfaced exactly once,
        however many times a supervised restart re-harvests its batch."""
        if not comps:
            return
        with self._completed_lock:
            fresh = [c for c in comps if c.rid not in self._delivered_rids]
            self._delivered_rids.update(c.rid for c in fresh)
        if not fresh:
            return
        self._resolve(fresh)
        with self._completed_lock:
            self._completed.extend(fresh)

    def poll(self) -> List[Completion]:
        """Un-started: serve synchronously (parity-oracle mode). Started:
        non-blocking pop of everything completed since the last poll.
        After stop() the completed backlog (including the shutdown flush's
        work) is still surfaced before falling back to the sync path."""
        if self._started:
            self._raise_if_failed()
        with self._completed_lock:
            out = list(self._completed)
            self._completed.clear()
        if not self._started:
            comps = super().poll()
            self._resolve(comps)
            out.extend(comps)
        return out

    def drain(self) -> List[Completion]:
        """Block until every submitted request has completed; returns the
        completions not yet surfaced through ``poll``."""
        if not self._started:
            comps = super().drain()
            self._resolve(comps)
            return comps
        self._drain_evt.set()
        with self._work_cv:
            self._work_cv.notify_all()
        try:
            with self._done_cv:
                while self._finished < self._submitted:
                    if self._thread_exc is not None or (
                            self._stop_evt.is_set()):
                        break
                    self._done_cv.wait(timeout=self._poll_interval * 5)
        finally:
            self._drain_evt.clear()
        self._raise_if_failed()
        with self._done_cv:
            if self._finished < self._submitted:
                raise RuntimeError("drain() interrupted by stop()")
        return self.poll()

    # -- batch-pipeline threads -------------------------------------------

    def _admit_loop(self) -> None:
        """Drive the deadline batcher; prepare released batches; feed the
        bounded dispatch queue (whose blocking ``put`` IS the pipeline's
        backpressure on admission work). A prepared batch is parked on
        ``_admit_holding`` until the queue accepts it, so a thread death
        mid-offer hands the batch to the restarted thread (or the stop
        flush) instead of dropping it."""
        while True:
            self._chaos("admit")
            prep = self._admit_holding
            if prep is None:
                out = self._batcher.poll()
                if out is None and self._drain_evt.is_set():
                    out = self._batcher.flush()
                if out is not None:
                    prep = self._prepare_batch(out[0], out[1], self.clock())
            if prep is not None:
                self._admit_holding = prep
                while True:
                    try:
                        self._prep_q.put(prep, timeout=0.1)
                        self._admit_holding = None
                        break
                    except queue_mod.Full:
                        if self._stop_evt.is_set():
                            # still holding: the stop flush serves it
                            self._put_stop()
                            return
                continue
            if self._stop_evt.is_set():
                self._put_stop()
                return
            with self._work_cv:
                exp = self._batcher.next_expiry()
                now = self.clock()
                tmo = (self._poll_interval if exp is None
                       else min(max(exp - now, 0.0), self._poll_interval))
                if tmo > 0:
                    self._work_cv.wait(timeout=tmo)

    def _put_stop(self) -> None:
        """Best-effort dispatch sentinel: never block on a full queue (the
        dispatcher may be dead). A dropped sentinel is safe: the dispatcher
        also exits on stop_evt once idle, and the stop flush serves
        whatever never got dispatched and discards stray sentinels."""
        try:
            self._prep_q.put_nowait(_STOP)
        except queue_mod.Full:
            pass

    def _harvest_head(self) -> bool:
        """Finish-and-deliver the OLDEST in-flight batch, exactly once.

        Peek-finish-pop (never pop-then-finish): the batch stays on the
        engine-owned deque until its completions are delivered, so a thread
        dying inside ``_finish_batch`` leaves it for the restarted thread.
        The ``bid`` guard skips a head whose predecessor died between
        delivering and popping; rid-dedup in ``_deliver`` backstops the
        symmetric window."""
        with self._inflight_lock:
            if not self._disp_inflight:
                return False
            p, o = self._disp_inflight[0]
        if p.bid not in self._harvested:
            comps = self._finish_batch(p, o)
            self._harvested.add(p.bid)
            self._deliver(comps)
        with self._inflight_lock:
            if self._disp_inflight and self._disp_inflight[0][0].bid == p.bid:
                self._disp_inflight.popleft()
            self._inflight = len(self._disp_inflight)
        return True

    def _dispatch_loop(self) -> None:
        """Launch prepared batches; keep up to ``pipeline_depth`` in
        flight; wait on results only when the pipeline is full or idle.
        In-flight batches live on ``self._disp_inflight`` (not the thread
        stack) so supervision restarts lose nothing."""
        depth = self.cfg.pipeline_depth
        while True:
            self._chaos("dispatch")
            try:
                prep = self._prep_q.get(timeout=self._poll_interval)
            except queue_mod.Empty:
                prep = None
            if prep is _STOP:
                while self._harvest_head():
                    pass
                return
            if prep is not None:
                with self._inflight_lock:
                    self._disp_inflight.append(
                        (prep, self._dispatch_batch(prep)))
                    self._inflight = len(self._disp_inflight)
                    full = len(self._disp_inflight) >= depth
                if full:
                    self._harvest_head()
            elif not self._harvest_head() and self._stop_evt.is_set():
                # Restarted after the _STOP sentinel was already consumed
                # (or a racing shutdown): nothing in flight, nothing queued;
                # the stop flush owns whatever is left.
                return

    # -- shutdown flush / loud failure ------------------------------------

    def _shutdown_flush(self) -> None:
        """Serve every batch the stopped pipeline left behind, on the
        caller's thread: dispatched-but-unharvested batches, the admit
        thread's parked offer, queued prepared batches, and the admission
        queue's remainder."""
        while self._harvest_head():
            pass
        leftovers: List[_Prepared] = []
        if self._admit_holding is not None:
            leftovers.append(self._admit_holding)
            self._admit_holding = None
        while True:
            try:
                prep = self._prep_q.get_nowait()
            except queue_mod.Empty:
                break
            if prep is not _STOP:
                leftovers.append(prep)
        for prep in leftovers:
            if prep.bid in self._harvested:
                continue
            comps = self._finish_batch(prep, self._dispatch_batch(prep))
            self._harvested.add(prep.bid)
            self._deliver(comps)
        while True:
            out = self._batcher.poll() or self._batcher.flush()
            if out is None:
                break
            prep = self._prepare_batch(out[0], out[1], self.clock())
            self._deliver(self._finish_batch(
                prep, self._dispatch_batch(prep)))

    def _error_completion(self, rid: int, reason: str,
                          k: Optional[int] = None) -> Completion:
        k = self.cfg.max_k if k is None else k
        return Completion(
            rid=rid, topk_ids=np.full((k,), -1, np.int32),
            topk_scores=np.full((k,), -np.inf, np.float32),
            queue_wait_s=0.0, latency_s=0.0, deadline_miss=True,
            flavor="error", bucket=(0, 0), reveal_fraction=0.0,
            coverage=0.0, error=reason)

    def _fail_pending(self, reason: str) -> None:
        """Resolve every still-pending future with a LOUD error completion:
        the zero-lost guarantee's last line. After stop() no submitted rid
        is unaccounted for and no future dangles."""
        with self._done_cv:
            pending = sorted(rid for rid, f in self._futures.items()
                             if not f.done())
        if pending:
            self._deliver([self._error_completion(rid, reason)
                           for rid in pending])

    def _fail_stream_slots(self, reason: str) -> None:
        """Fail the continuous stream's occupied slots (their frontier
        state died with the stream thread)."""
        slots = self._stream_slots
        comps = []
        for s, r in enumerate(slots):
            if r is not None:
                comps.append(self._error_completion(r.rid, reason, k=r.k))
                slots[s] = None
        self._deliver(comps)

    # -- continuous (slot-refill) thread ----------------------------------

    def _stream_loop(self) -> None:
        """Slot-level continuous batching: one resumable frontier of
        ``batch_size`` slots; retired slots are harvested and refilled
        from the admission queue between slices while the other slots'
        bandit state carries forward on the device."""
        cfg = self.cfg
        B = cfg.batch_size
        tb, nb = self._stream_bucket
        exe = self._executable(("stream", tb, nb))
        M = self.corpus_embs.shape[2]
        draws, base = self._draws, self._base_seed
        state = init_stream_state(B, nb, tb, device=self.device)
        seeds = draws.split(base, B)
        slot: List[Optional[Request]] = [None] * B
        # Engine-visible alias: a supervised restart fails the occupied
        # slots loudly (their frontier state died with this thread).
        self._stream_slots = slot
        slot_fill = [0.0] * B
        queries = np.zeros((B, tb, M), np.float32)
        cand = np.full((B, nb), -1, np.int32)
        a_np = np.zeros((B, nb, tb), np.float32)
        b_np = np.zeros((B, nb, tb), np.float32)

        while True:
            self._chaos("stream")
            # 1. Refill retired slots from the admission queue.
            newly: List[int] = []
            for s in range(B):
                if slot[s] is not None:
                    continue
                with self._work_cv:
                    r = (self._stream_q.popleft() if self._stream_q
                         else None)
                if r is None:
                    break
                slot[s] = r
                slot_fill[s] = self.clock()
                newly.append(s)
            fresh = np.zeros((B,), bool)
            if newly:
                need = [s for s in newly if slot[s].cand_ids is None]
                if need:
                    ids1, a1, b1 = self._stage1(tb, pad_queries(
                        [slot[s].query for s in need], tb))
                    stage1_row = {s: j for j, s in enumerate(need)}
                n1 = self._stage1_n
                for s in newly:
                    r = slot[s]
                    queries[s] = 0.0
                    queries[s, :r.query.shape[0]] = r.query
                    if r.cand_ids is None:
                        j = stage1_row[s]
                        cand[s] = -1
                        cand[s, :n1] = ids1[j]
                        a_np[s] = 0.0
                        b_np[s] = 0.0
                        a_np[s, :n1] = a1[j]
                        b_np[s, :n1] = b1[j]
                    else:
                        row = pad_candidates([r.cand_ids], nb)
                        cand[s] = row[0]
                        aa, bb = support_bounds(row, [r.query.shape[0]],
                                                tb, cfg.support)
                        a_np[s], b_np[s] = aa[0], bb[0]
                    seeds[s] = draws.fold_in(base, r.rid)
                    fresh[s] = True

            live = [s for s in range(B) if slot[s] is not None]
            if not live:
                if self._stop_evt.is_set():
                    return
                with self._work_cv:
                    if not self._stream_q:
                        self._work_cv.wait(timeout=self._poll_interval)
                continue

            # 2. One slice: every live slot advances trip_limit trips.
            t0 = self.clock()
            *outs, state = exe(
                self.corpus_embs, self.corpus_mask, self._tensor(queries),
                self._tensor(cand), self._tensor(a_np), self._tensor(b_np),
                state, self._tensor(fresh), seeds)
            scores, gids, frac, stats, harvest = (x.cpu().numpy()
                                                  for x in outs)
            t_done = self.clock()

            # 3. Harvest retired slots.
            comps: List[Completion] = []
            for s in live:
                if not harvest[s]:
                    continue
                r = slot[s]
                comps.append(Completion(
                    rid=r.rid,
                    topk_ids=gids[s, :r.k].copy(),
                    topk_scores=scores[s, :r.k].copy(),
                    queue_wait_s=slot_fill[s] - r.arrival,
                    latency_s=t_done - r.arrival,
                    deadline_miss=(r.deadline_abs is not None
                                   and t_done > r.deadline_abs + 1e-9),
                    flavor="bandit", bucket=(tb, nb),
                    reveal_fraction=float(frac[s]),
                    coverage=r.coverage_scale))
                slot[s] = None
            service_s = t_done - t0
            with self._state_lock:
                self._service_ema = (
                    service_s if not self.metrics.batches
                    else 0.7 * self._service_ema + 0.3 * service_s)
            self.metrics.record_batch(BatchRecord(
                bucket=(tb, nb), flavor="bandit", n_real=len(live),
                occupancy=len(live) / B, service_s=service_s,
                reveal_fraction=float(np.mean(frac[live])),
                frontier_occupancy=float(stats[0]),
                total_rounds=float(stats[1]),
                lockstep_waste=float(stats[2]),
                quarantined=float(stats[3])), comps)
            self._deliver(comps)
