"""Continuous-batching serve engine with a slot-based KV cache and
straggler-aware decode control (port of ``repro.launch.serve``).

What it does, as the reference:

* **Request queue + admission control** — FIFO queue (bounded via
  ``max_queue``); a request is admitted when a KV slot is free and its
  arrival step has passed.
* **Slot-based KV cache** — one cache padded to ``num_slots``, each slot
  at its own position; a recycled slot's rows are zeroed on admission.
* **Chunked prefill** — every step feeds each active slot either up to
  ``prefill_chunk`` teacher-forced prompt positions or one greedy decode
  token, as ``[C, num_slots]`` substeps of one engine step; lanes with
  nothing to feed in a substep run at ``INVALID_POS`` and write nothing.
* **Straggler-aware decode** — a χ-schedule feeds the iteration-time
  model; the :class:`SemiController` plans through the
  :class:`ControlPlane`; ``--control zero`` ZERO-resizes the decode
  matmuls of the (simulated) contended rank. Plans sized on a simulated
  group (``--sim-ranks``) are projected onto the real group.

The engine's clock and per-token latencies are MODELED from the
iteration-time model (``peak_flops`` is a host-CPU calibration), exactly
as in the reference; the host wall time of each step is reported beside
them as ``wall_s``.

This slice runs ``tp == 1`` with the fixed slot cache. Paging, int8 K/V,
a ragged shard geometry, checkpoint loading, ``tp > 1`` and the
migration modes raise ``NotImplementedError`` naming the slice that
brings them.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --control zero --hetero contention --chi 4 --sim-ranks 8 \\
        --fused-attn --use-kernel
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig, get_config, smoke_variant
from repro_torch.control import ControlConfig, ControlPlane
from repro_torch.control import scopes as scopes_lib
from repro_torch.core import hetero as hetero_lib
from repro_torch.core import paging as paging_lib
from repro_torch.layers.tp_linear import TRAINING_SLICE, ControlContext
from repro_torch.models import lm as lm_lib

PAGED_SLICE = "the paged serving slice (ROADMAP.md, queue A)"
CHECKPOINT_SLICE = "the training slice's checkpoint port (ROADMAP.md, queue A)"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """The engine's device; a CUDA request without a GPU raises instead of
    carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the GPU "
            "unless the caller passes device='cpu'")
    return dev


# ---------------------------------------------------------------------------
# Requests / completions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_step``: engine step at which the
    request becomes eligible for admission (0 = immediately)."""

    uid: int
    prompt: np.ndarray                 # [P] int32 prompt tokens
    max_new_tokens: int
    arrival_step: int = 0
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    uid: int
    prompt: np.ndarray
    tokens: np.ndarray                 # generated tokens (<= max_new_tokens)
    admitted_step: int
    finished_step: int
    slot: int
    token_latencies: List[float]       # modeled seconds per emitted token
    # first entry includes queue wait + prefill (time-to-first-token)


@dataclasses.dataclass(frozen=True)
class LoadSnapshot:
    """What a cluster router sees of one engine: queue/slot load, the
    per-rank χ feed, and the plan-adjusted modeled step time."""

    step: int
    clock: float
    queue_depth: int
    active: int
    free_slots: int
    free_pages: Optional[int]          # None = fixed (non-paged) cache
    num_slots: int
    chi: np.ndarray
    work_frac: np.ndarray
    step_time_s: float
    dense_step_time_s: float
    backlog_steps: int


@dataclasses.dataclass
class _Slot:
    req: Request
    admitted_step: int
    pos: int = 0                       # NEXT cache position to feed
    next_token: int = 0                # token to feed this step (decode)
    generated: Optional[list] = None
    t_mark: float = 0.0                # engine clock at last token emission
    t_elig: float = 0.0                # clock at TTFT eligibility
    latencies: Optional[list] = None


# ---------------------------------------------------------------------------
# Cache-tree helpers (leaves with a "batch" axis are per-slot state)
# ---------------------------------------------------------------------------


def _tree_leaves_with_axes(tree, axes):
    """(leaf, axes) pairs of a cache tree of dicts / tuples / lists."""
    if isinstance(tree, torch.Tensor):
        yield tree, axes
    elif isinstance(tree, dict):
        for k in tree:
            yield from _tree_leaves_with_axes(tree[k], axes[k])
    else:
        for t, a in zip(tree, axes):
            yield from _tree_leaves_with_axes(t, a)


def _batch_axis(leaf: torch.Tensor, ax) -> Optional[int]:
    ax_full = (None,) * (leaf.ndim - len(ax)) + tuple(ax)
    return ax_full.index("batch") if "batch" in ax_full else None


def _clear_slots(cache, cache_ax, clear: np.ndarray) -> None:
    """Zero the recycled slots' rows of every batch-axis leaf, in place
    (the reference multiplies by ``1 - clear``)."""
    rows = np.nonzero(clear > 0.0)[0]
    if rows.size == 0:
        return
    for leaf, ax in _tree_leaves_with_axes(cache, cache_ax):
        b = _batch_axis(leaf, ax)
        if b is not None:
            leaf.index_fill_(b, torch.as_tensor(rows, device=leaf.device), 0)


def _merge_invalid(old, new, cache_ax, valid: torch.Tensor):
    """Chunked-prefill lane merge: a substep's invalid lanes must not
    advance that slot's state, so every batch-axis leaf keeps its
    pre-substep value on those lanes. A leaf the step updated in place
    (``new is old``, the K/V cache) already did: its write is masked at
    the source, so there is nothing to restore."""
    def one(o, n, ax):
        if isinstance(n, torch.Tensor):
            b = _batch_axis(n, ax)
            if b is None or n is o:
                return n
            shp = [1] * n.ndim
            shp[b] = valid.shape[0]
            return torch.where((valid > 0.0).reshape(shp), n, o)
        if isinstance(n, dict):
            return {k: one(o[k], n[k], ax[k]) for k in n}
        return type(n)(one(oi, ni, ai) for oi, ni, ai in zip(o, n, ax))
    return one(old, new, cache_ax)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class ServeEngine:
    """Continuous-batching decode engine over a fixed slot set.

    Differences from the reference's constructor: ``device`` (default
    ``"cuda"``; the tests pass ``"cpu"``) and ``model_cfg``, which, when
    given, replaces the ``smoke_variant(get_config(arch))`` the engine
    serves otherwise (so a caller can serve a full-width config).
    """

    def __init__(self, arch: str, num_slots: int = 4, max_len: int = 64, *,
                 tp: int = 1, ckpt_dir: Optional[str] = None, seed: int = 0,
                 control: Optional[ControlConfig] = None,
                 param_dtype: str = "float32",
                 max_queue: Optional[int] = None,
                 page_size: int = 0, prefill_chunk: int = 1,
                 kv_int8: bool = False,
                 num_pages: Optional[int] = None,
                 trace_tag: Optional[Dict] = None,
                 device="cuda",
                 model_cfg: Optional[ModelConfig] = None):
        self.control = control or ControlConfig()
        c = self.control
        if page_size > 0 or kv_int8 or num_pages is not None:
            raise NotImplementedError(
                f"the paged KV pool and int8 K/V come with {PAGED_SLICE}")
        if c.geometry is not None:
            raise NotImplementedError(
                f"a ragged shard geometry comes with {TRAINING_SLICE}")
        if ckpt_dir:
            raise NotImplementedError(
                f"loading a checkpoint comes with {CHECKPOINT_SLICE}")
        if tp != 1:
            raise NotImplementedError(
                f"serving at tp={tp} comes with {TRAINING_SLICE}")
        if c.mode in ("mig", "semi"):
            raise NotImplementedError(
                f"control mode {c.mode!r} (migration) comes with "
                f"{TRAINING_SLICE}")
        self.cfg = (model_cfg if model_cfg is not None
                    else smoke_variant(get_config(arch)))
        if self.cfg.encdec is not None:
            raise ValueError(f"{arch}: the serve engine drives decoder-only "
                             "models (LM/SSM/hybrid/MoE)")
        if param_dtype not in _DTYPES:
            raise ValueError(f"param_dtype must be one of {sorted(_DTYPES)}")
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.max_len = max_len
        self.tp = tp
        self.max_queue = max_queue
        dtype = _DTYPES[param_dtype]
        self.prefill_chunk = max(1, int(prefill_chunk))

        wc = c.to_workload()
        self._wc = wc
        # the step's model config: the fused decode-attention kernel is a
        # model-level switch (the dense ctx=None path takes it too)
        self._step_cfg = (dataclasses.replace(self.cfg, fused_decode_attn=True)
                          if wc.fused_attention else self.cfg)
        self._cache_ax = lm_lib.cache_axes(self.cfg)
        step_cfg, cache_ax, dev = self._step_cfg, self._cache_ax, self.device
        invalid_pos = int(paging_lib.INVALID_POS)

        def _build(static):
            if static is not None:
                static = dataclasses.replace(
                    static,
                    scope_blocks=scopes_lib.scope_block_table(self.cfg, static))

            def stepper(params, cache, tokens, pos, valid, clear, plan=None):
                # tokens/pos/valid are host [C, num_slots] arrays: C
                # chunked-prefill substeps of one engine step (C=1 is the
                # plain decode step); clear marks slots recycled this step
                _clear_slots(cache, cache_ax, clear)
                ctx = (ControlContext(
                    static=static, bucket_by_rank=plan["bucket_by_rank"],
                    pri=plan["pri"], use_kernel=wc.use_kernel)
                    if static is not None else None)
                p_eff = np.where(valid > 0.0, pos, invalid_pos).astype(
                    np.int32)
                tok_d = torch.as_tensor(tokens).to(dev)
                pos_d = torch.as_tensor(p_eff).to(dev)
                valid_d = torch.as_tensor(valid).to(dev)
                toks = torch.zeros(tokens.shape, dtype=torch.int32,
                                   device=dev)
                # each lane's valid substeps are a prefix, so substeps past
                # the longest one have no valid lane: they would write
                # nothing and their tokens are never read — skip them
                # (a decode-only step runs one substep, not C)
                n_sub = int((valid > 0.0).sum(axis=0).max(initial=0))
                for i in range(n_sub):
                    logits, nc = lm_lib.decode_step(
                        params, step_cfg, cache, tok_d[i], pos_d[i], ctx=ctx)
                    cache = _merge_invalid(cache, nc, cache_ax, valid_d[i])
                    # greedy argmax on the device: only [C, num_slots]
                    # token ids cross to the host
                    toks[i] = torch.argmax(logits, dim=-1)
                return toks, cache

            return stepper

        # ---- the control plane (build cache + controller + telemetry) ----
        self.sim_ranks = c.sim_ranks or tp
        self.it_model = hetero_lib.iteration_model(
            self.cfg, ShapeConfig("serve_model", 1, num_slots, "decode"),
            max(self.sim_ranks, 1), peak_flops=c.peak_flops, mfu=c.mfu)
        self.overhead = (hetero_lib.decode_overhead_model(
            self.cfg, num_slots, max_len, self.it_model,
            peak_flops=c.peak_flops, tile=128)
            if c.model_decode_overheads else None)
        self.plane = ControlPlane(
            self.cfg, wc, tp=tp, builder=_build, device=self.device,
            it_model=self.it_model, sim_ranks=self.sim_ranks,
            hetero_kind=c.hetero_kind, chi=c.chi, period=c.period,
            contention_p=c.contention_p, seed=c.seed,
            trace_in=c.trace_in, trace_rank_offset=c.trace_rank_offset,
            trace_out=c.trace_out,
            trace_meta={"arch": arch, "engine": "serve", "mode": c.mode,
                        "hetero": c.hetero_kind, "seed": c.seed,
                        **(trace_tag or {})},
            measure_noise=c.measure_noise)
        self._base_step = self.plane.base
        self.schedule = self.plane.schedule
        self.controller = self.plane.controller

        # ---- params + slot cache ----------------------------------------
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        # a plain assignable attribute: callers may install other weights
        self.params = lm_lib.init(gen, self.cfg, dtype, self.device)
        self.cache = lm_lib.init_cache(self.cfg, num_slots, max_len, dtype,
                                       self.device)

        # ---- host-side state ---------------------------------------------
        self.queue: collections.deque = collections.deque()
        self._eligible_clock: Dict[int, float] = {}   # req.uid -> TTFT start
        self.slots: List[Optional[_Slot]] = [None] * num_slots
        self.free: List[int] = list(range(num_slots))[::-1]
        self.step_count = 0
        self.clock = 0.0                     # modeled seconds
        self.completions: List[Completion] = []
        self.history: List[Dict] = []

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """FIFO admission control; False = queue full, request rejected.
        Raises on requests that can never fit in ``max_len``."""
        need = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) == 0 or need > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {len(req.prompt)} + "
                f"max_new_tokens {req.max_new_tokens} exceeds the engine's "
                f"max_len {self.max_len}")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return False
        self.queue.append(req)
        # time-to-first-token starts when the request becomes ELIGIBLE
        # (arrival), not when a slot frees up; keyed by req.uid
        if req.arrival_step <= self.step_count:
            self._eligible_clock.setdefault(req.uid, self.clock)
        return True

    def try_submit(self, req: Request) -> bool:
        """Non-blocking admission: ``False`` means NOTHING was enqueued
        (queue at ``max_queue``, or a request that can never fit)."""
        need = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) == 0 or need > self.max_len:
            return False
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return False
        return self.submit(req)

    def _admit(self):
        """Returns (admitted uids, slot-clear mask for this step)."""
        clear = np.zeros((self.num_slots,), np.float32)
        admitted = []
        for req in self.queue:
            if req.arrival_step <= self.step_count:
                self._eligible_clock.setdefault(req.uid, self.clock)
        while self.free and self.queue \
                and self.queue[0].arrival_step <= self.step_count:
            req = self.queue.popleft()
            slot = self.free.pop()
            t0 = self._eligible_clock.pop(req.uid, self.clock)
            self.slots[slot] = _Slot(
                req=req, admitted_step=self.step_count, pos=0,
                next_token=int(req.prompt[0]), generated=[],
                t_mark=t0, t_elig=t0, latencies=[])
            clear[slot] = 1.0
            admitted.append(req.uid)
        return admitted, clear

    # -- one decode step -----------------------------------------------------
    def step(self) -> Dict:
        """Admit, run one engine step over all slots, harvest."""
        admitted, clear = self._admit()

        C = self.prefill_chunk
        B = self.num_slots
        tokens_cb = np.zeros((C, B), np.int32)
        pos_cb = np.full((C, B), paging_lib.INVALID_POS, np.int32)
        valid_cb = np.zeros((C, B), np.float32)
        feed = np.zeros((B,), np.int32)       # positions fed per slot
        last_pos = np.zeros((B,), np.int32)   # highest position fed
        active = np.zeros((B,), np.float32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            active[i] = 1.0
            P = len(s.req.prompt)
            if s.pos < P:                     # teacher-forced prefill chunk
                n = min(C, P - s.pos)
                tokens_cb[:n, i] = np.asarray(s.req.prompt[s.pos:s.pos + n],
                                              np.int32)
                pos_cb[:n, i] = np.arange(s.pos, s.pos + n)
            else:                             # one greedy decode token
                n = 1
                tokens_cb[0, i] = s.next_token
                pos_cb[0, i] = s.pos
            valid_cb[:n, i] = 1.0
            feed[i] = n
            last_pos[i] = s.pos + n - 1

        # chunked prefill feeds MORE than one token per occupied slot;
        # price the extra substep work as extra workload fraction
        chunk_scale = 1.0 + max(0.0, float(valid_cb.sum())
                                - float(active.sum())) / self.num_slots

        # -- straggler model + plan selection -----------------------------
        step_idx = self.step_count
        chis = self.plane.chis(step_idx)
        dense_latency = self.it_model.step_time(chis, np.ones(self.sim_ranks))
        plan_report = None
        plan = None
        frac = np.ones(self.sim_ranks)
        if self.controller is not None:
            times = self.plane.controller_times(chis)
            plan, plan_report = self.plane.decide(times)
            step_fn, plan_arrays, _ = self.plane.dispatch(plan)
            frac = self.plane.work_frac(plan)
            latency = self.it_model.step_time(chis, frac * chunk_scale)
        else:
            step_fn, plan_arrays = self._base_step, None
            latency = (dense_latency if chunk_scale == 1.0
                       else self.it_model.step_time(
                           chis, np.ones(self.sim_ranks) * chunk_scale))

        self.plane.timer.start()
        with torch.no_grad():
            tok_ids, self.cache = step_fn(self.params, self.cache, tokens_cb,
                                          pos_cb, valid_cb, clear,
                                          plan_arrays)
        wall = self.plane.timer.stop(tok_ids)
        nxt = tok_ids.cpu().numpy()           # [C, num_slots]
        overhead = 0.0
        if self.schedule is None:
            latency = dense_latency = wall       # no simulation: real time
        elif self.overhead is not None:
            overhead = self.overhead.overhead_s(
                last_pos, fused=self._wc.fused_attention,
                psum_chunks=self._wc.psum_chunks, active=active)
            latency += overhead

        # -- telemetry: what each simulated rank measured THIS step -------
        self.plane.capture(chis, frac, step=step_idx, plan=plan, wall=wall)

        self.clock += latency
        self.step_count += 1

        # -- harvest per slot ---------------------------------------------
        completed = []
        for i, s in enumerate(self.slots):
            if s is None or feed[i] == 0:
                continue
            n = int(feed[i])
            prev = s.pos
            s.pos = prev + n
            P = len(s.req.prompt)
            if prev < P and s.pos < P:
                continue                         # still mid-prefill
            tok = int(nxt[n - 1, i])
            emitted = False
            if len(s.generated) < s.req.max_new_tokens:
                s.generated.append(tok)
                s.latencies.append(self.clock - s.t_mark)
                s.t_mark = self.clock
                emitted = True
            done = (len(s.generated) >= s.req.max_new_tokens
                    or (emitted and s.req.eos_id is not None
                        and tok == s.req.eos_id))
            if done or s.pos >= self.max_len:
                self.completions.append(Completion(
                    uid=s.req.uid, prompt=s.req.prompt,
                    tokens=np.asarray(s.generated, np.int32),
                    admitted_step=s.admitted_step,
                    finished_step=self.step_count, slot=i,
                    token_latencies=list(s.latencies)))
                completed.append(s.req.uid)
                self._eligible_clock.pop(s.req.uid, None)
                self.slots[i] = None
                self.free.append(i)
            else:
                s.next_token = tok

        report = {"step": self.step_count, "latency_s": latency,
                  "dense_latency_s": dense_latency, "wall_s": wall,
                  "active": sum(s is not None for s in self.slots),
                  "admitted": admitted, "completed": completed,
                  "queued": len(self.queue)}
        if self.overhead is not None:
            report["overhead_s"] = overhead
            report["occupancy"] = float(
                ((last_pos + 1.0) * active).sum()
                / (self.num_slots * self.max_len))
            report["attn_bound_s"] = self.overhead.attn_s(
                last_pos, fused=True, active=active)
        if plan_report is not None:
            report["stragglers"] = list(plan_report.stragglers)
            report["max_bucket"] = int(plan_report.bucket_by_rank.max())
        self.history.append(report)
        return report

    # -- cluster-driver API ----------------------------------------------------
    @property
    def idle(self) -> bool:
        """No active slots and nothing queued."""
        return not self.queue and all(s is None for s in self.slots)

    def tick(self) -> Dict:
        """One cluster-driver step: a full step when any slot is occupied
        or a queued request is admissible, otherwise an IDLE tick (the
        step counter advances, the modeled clock does not, no device work
        runs)."""
        admissible = bool(
            self.free and self.queue
            and self.queue[0].arrival_step <= self.step_count)
        if admissible or any(s is not None for s in self.slots):
            return self.step()
        for req in self.queue:
            if req.arrival_step <= self.step_count:
                self._eligible_clock.setdefault(req.uid, self.clock)
        self.step_count += 1
        report = {"step": self.step_count, "idle": True, "latency_s": 0.0,
                  "dense_latency_s": 0.0, "wall_s": 0.0, "active": 0,
                  "admitted": [], "completed": [],
                  "queued": len(self.queue)}
        self.history.append(report)
        return report

    def request_cost_steps(self, prompt_len: int,
                           max_new_tokens: int) -> int:
        """Engine steps a request will occupy a slot for: its prefill
        chunks plus one step per generated token."""
        return -(-int(prompt_len) // self.prefill_chunk) \
            + int(max_new_tokens)

    def load_snapshot(self) -> LoadSnapshot:
        """Queue/slot load + plan-adjusted capacity, for routing."""
        backlog = 0
        for s in self.slots:
            if s is None:
                continue
            P = len(s.req.prompt)
            backlog += -(-(P - min(s.pos, P)) // self.prefill_chunk) \
                + (s.req.max_new_tokens - len(s.generated))
        for req in self.queue:
            backlog += self.request_cost_steps(len(req.prompt),
                                               req.max_new_tokens)
        cap = self.plane.capacity(self.step_count)
        return LoadSnapshot(
            step=self.step_count, clock=self.clock,
            queue_depth=len(self.queue),
            active=sum(s is not None for s in self.slots),
            free_slots=len(self.free), free_pages=None,
            num_slots=self.num_slots,
            chi=cap.chi, work_frac=cap.work_frac,
            step_time_s=cap.step_time_s,
            dense_step_time_s=cap.dense_step_time_s,
            backlog_steps=backlog)

    def evict_queue(self) -> List[Request]:
        """Pop every queued (not yet admitted) request."""
        out = list(self.queue)
        self.queue.clear()
        for req in out:
            self._eligible_clock.pop(req.uid, None)
        return out

    def active_requests(self) -> List[Request]:
        """Requests currently holding a slot, in admission order."""
        order = sorted((i for i, s in enumerate(self.slots)
                        if s is not None),
                       key=lambda i: (self.slots[i].admitted_step, i))
        return [self.slots[i].req for i in order]

    # -- drivers -------------------------------------------------------------
    def run(self, requests: List[Request],
            max_steps: Optional[int] = None) -> List[Completion]:
        """Replay an arrival trace until every request completes; requests
        are submitted AT their arrival step."""
        if not requests:
            return []
        pending = collections.deque(sorted(requests,
                                           key=lambda r: r.arrival_step))
        limit = max_steps or (self.max_len * (len(requests) + 1)
                              + pending[-1].arrival_step)
        while (pending or self.queue
               or any(s is not None for s in self.slots)):
            if self.step_count >= limit:
                raise RuntimeError(f"serve loop exceeded {limit} steps")
            while pending and pending[0].arrival_step <= self.step_count:
                r = pending.popleft()
                if not self.submit(r):
                    raise RuntimeError(f"queue full, request {r.uid} "
                                       "rejected")
            self.step()
        return sorted(self.completions, key=lambda c: c.uid)

    def close(self) -> None:
        """Flush/close the telemetry trace (safe to call repeatedly)."""
        self.plane.close()


#: The zero-traffic stats record: every key of the non-empty record,
#: all zero.
EMPTY_LATENCY_STATS = {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                       "mean_ms": 0.0, "ttft_mean_ms": 0.0, "tokens": 0,
                       "requests": 0, "tok_per_s": 0.0}


def latency_percentiles(completions: List[Completion],
                        total_time_s: Optional[float] = None
                        ) -> Dict[str, float]:
    """p50/p95/p99 per-token latency (ms), mean TTFT + tokens/s, over the
    completions' (modeled) token latencies. Pass the engine's elapsed
    clock as ``total_time_s`` for engine throughput."""
    lats = np.asarray([l for c in completions for l in c.token_latencies])
    if lats.size == 0:
        return dict(EMPTY_LATENCY_STATS)
    ttft = [c.token_latencies[0] for c in completions if c.token_latencies]
    span = total_time_s if total_time_s is not None else float(lats.sum())
    return {"p50_ms": float(np.percentile(lats, 50) * 1e3),
            "p95_ms": float(np.percentile(lats, 95) * 1e3),
            "p99_ms": float(np.percentile(lats, 99) * 1e3),
            "mean_ms": float(lats.mean() * 1e3),
            "ttft_mean_ms": float(np.mean(ttft) * 1e3),
            "tokens": int(lats.size),
            "requests": len(completions),
            "tok_per_s": float(lats.size / max(span, 1e-12))}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="steps between request arrivals (staggered trace)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--control", default="off",
                    choices=["off", "zero", "semi"])
    ap.add_argument("--hetero", default="none",
                    choices=["none", "static", "round_robin", "contention",
                             "trace"])
    ap.add_argument("--chi", type=float, default=4.0)
    ap.add_argument("--sim-ranks", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="pruned products through the CUDA kernels")
    ap.add_argument("--fused-attn", action="store_true",
                    help="decode attention through the fused CUDA kernel")
    ap.add_argument("--times", default="modeled",
                    choices=["modeled", "measured"],
                    help="controller input: χ-oracle or the online "
                         "StragglerEstimator over measured decode times")
    ap.add_argument("--trace-in", default=None,
                    help="telemetry trace to replay (with --hetero trace)")
    ap.add_argument("--trace-out", default=None,
                    help="record a replayable telemetry trace here (JSONL)")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="prompt positions fed per step during prefill")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless you ask for cpu)")
    args = ap.parse_args(argv)

    control = ControlConfig(
        mode=args.control, hetero_kind=args.hetero, chi=args.chi,
        sim_ranks=args.sim_ranks, use_kernel=args.use_kernel,
        fused_attention=args.fused_attn, times=args.times, trace_in=args.trace_in, trace_out=args.trace_out)
    eng = ServeEngine(args.arch, num_slots=args.slots,
                      max_len=args.prompt_len + args.gen_len, tp=args.tp,
                      control=control, prefill_chunk=args.prefill_chunk,
                      device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, eng.cfg.vocab_size,
                                        (args.prompt_len,)).astype(np.int32),
                    max_new_tokens=args.gen_len,
                    arrival_step=i * args.arrival_every)
            for i in range(args.requests)]
    t0 = time.time()
    comps = eng.run(reqs)
    eng.close()
    wall = time.time() - t0
    stats = latency_percentiles(comps, total_time_s=eng.clock)
    for c in comps[:4]:
        print(f"req {c.uid}: slot {c.slot}, steps "
              f"{c.admitted_step}->{c.finished_step}, "
              f"tokens {c.tokens[:8]}...")
    print(f"{len(comps)} requests, {stats['tokens']} tokens in {wall:.1f}s "
          f"wall on {eng.device}; modeled p50/p95/p99 per-token "
          f"{stats['p50_ms']:.2f}/{stats['p95_ms']:.2f}/"
          f"{stats['p99_ms']:.2f} ms, {stats['tok_per_s']:.1f} tok/s "
          "(modeled clock)")
    print(f"plan builds: {eng.plane.counts()}")


if __name__ == "__main__":
    main()
