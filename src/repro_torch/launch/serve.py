"""Continuous-batching serve engine with a slot-based KV cache and
straggler-aware decode control (port of ``repro.launch.serve``).

What it does, as the reference:

* **Request queue + admission control** — FIFO queue (bounded via
  ``max_queue``); a request is admitted when a KV slot is free and its
  arrival step has passed.
* **Slot-based KV cache** — one cache padded to ``num_slots``, each slot
  at its own position; a recycled slot's rows are zeroed on admission.
* **Paged KV pool** (``page_size > 0``) — attention cache leaves live in
  a shared ``[num_pages, page_size, ...]`` pool addressed through a
  host-side page table (``core/paging.py``); each step grows the slots'
  page lists to cover its writes, preempting the most recently admitted
  other slot (its request goes back to the front of the queue) when the
  pool runs dry. ``kv_int8`` keeps the GQA pools in int8 with per-row
  f32 scales (oracle attention only).
* **Chunked prefill** — every step feeds each active slot either up to
  ``prefill_chunk`` teacher-forced prompt positions or one greedy decode
  token, as ``[C, num_slots]`` substeps of one engine step; lanes with
  nothing to feed in a substep run at ``INVALID_POS`` and write nothing.
* **Straggler-aware decode** — a χ-schedule feeds the iteration-time
  model; the :class:`SemiController` plans through the
  :class:`ControlPlane`; ``--control zero`` ZERO-resizes the decode
  matmuls of the (simulated) contended rank, ``--control semi`` (and
  ``mig``) also migrates up to ``max_sources`` stragglers' FFN blocks to
  the helper ranks, losslessly under ``beta_policy="lossless"``. Plans
  sized on a simulated group (``--sim-ranks``) are projected onto the
  real group; each step's history records what EXECUTED (``mig_srcs`` /
  ``mig_shed``) beside the controller's intent (``planned_mig_srcs`` /
  ``planned_mig_shed``).
* **Tensor parallelism** — ``tp`` ranks of one group run in one process
  (:class:`repro_torch.parallel.TPGroup`, as in the trainer): under a
  plan, the controlled layers compute each rank's shard and sum the
  partials in rank order (``psum_chunks`` splits that sum). A MoE layer
  follows its ``expert_sharding``: ``"tp"`` keeps 1/tp of every expert's
  hidden width per rank and sums once per token; ``"expert"``
  (DeepSeek-V2) keeps each expert whole, the single-group function.
  Without a plan (``--control off``) the step is the dense
  product on the global weights, the same function.
* **Warm load** — ``ckpt_dir`` loads the newest committed checkpoint's
  parameters (either package's; a full train state or params only),
  cast to ``param_dtype``.
* **Fixed-batch baseline** — :class:`FixedBatchEngine` decodes fixed
  batches one token a step from the same seeded weights
  (:func:`init_params`): the oracle that slot recycling and cluster
  routing (``repro_torch.cluster``) are held against.

The engine's clock and per-token latencies are MODELED from the
iteration-time model (``peak_flops`` is a host-CPU calibration), exactly
as in the reference; the host wall time of each step is reported beside
them as ``wall_s``.

* **Ragged static shard geometry** (``ControlConfig.geometry``,
  :mod:`repro_torch.core.geometry`) — per-rank FFN block counts: the
  step's config carries the padded ``d_ff``, parameters are initialized
  (and checkpoints loaded) CANONICAL and expanded into the zero-padded
  layout, the latency model prices the canonical config, and the
  controller plans relative to the static split. MoE and SSM models stay
  equal-split (``ValueError``).

The engine serves dense GQA models (Yi-6B) and DeepSeek-V2 (MLA + MoE),
over the slot cache or the paged pool. Per-layer plans
(``selection="priority_diff"``) raise ``NotImplementedError`` naming the
slice that brings them.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --control zero --hetero contention --chi 4 --sim-ranks 8 \\
        --fused-attn --use-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --tp 4 --control semi --hetero contention --chi 4 --sim-ranks 8 \\
        --max-sources 3 --beta-policy lossless --psum-chunks 2 \\
        --fused-attn --use-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b --page-size 8 --num-pages 12 \\
        --control zero --hetero contention --sim-ranks 8 --fused-attn
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --tp 2 --control semi --hetero static --chi 3 --geometry 40,24
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.config import ModelConfig, ShapeConfig, get_config, smoke_variant
from repro_torch.control import ControlConfig, ControlPlane
from repro_torch.control import scopes as scopes_lib
from repro_torch.core import geometry as geom_lib
from repro_torch.core import hetero as hetero_lib
from repro_torch.core import paging as paging_lib
from repro_torch.layers.blocks import LM_TRAIN_SLICE
from repro_torch.layers.tp_linear import ControlContext
from repro_torch.models import lm as lm_lib
from repro_torch.parallel import TPGroup, ragged_local_width

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


def init_params(cfg: ModelConfig, seed: int, dtype: torch.dtype, device,
                ckpt_dir: Optional[str] = None) -> lm_lib.LM:
    """The engines' weights: random from one generator on ``device`` seeded
    with ``seed``, initialized directly in ``dtype``; with ``ckpt_dir``, the
    newest committed checkpoint's parameters (either package's) replace
    them. Engines of one seed, config and dtype hold the same bits."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = lm_lib.init(gen, cfg, dtype, device)
    if ckpt_dir:
        # race-tolerant latest-committed load: a warm spare may be
        # promoted while a trainer is mid-save in the same directory
        _, loaded = ckpt_store.load_latest_params(
            ckpt_dir, bridge.params_template(params))
        if loaded is not None:
            bridge.load_params(params, loaded)
    return params


def release_device_memory(device) -> None:
    """Collect what is no longer reachable and, on a CUDA device, hand the
    caching allocator's free blocks back to the card. An engine is a
    reference cycle (its control plane keeps a closure over it), so its
    parameters and cache leave the device only once collected."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


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


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: a
    blocking upload waits for every launch queued before it (a host sync
    in the step, rule R2 of repro_torch.analysis); an asynchronous one
    from pageable memory is staged at once and needs no wait."""
    return torch.as_tensor(a).to(device, non_blocking=True)


def _clear_slots(cache, cache_ax, clear: np.ndarray) -> None:
    """Zero the recycled slots' rows of every batch-axis leaf, in place
    (the reference multiplies by ``1 - clear``)."""
    rows = np.nonzero(clear > 0.0)[0]
    if rows.size == 0:
        return
    for leaf, ax in _tree_leaves_with_axes(cache, cache_ax):
        b = _batch_axis(leaf, ax)
        if b is not None:
            leaf.index_fill_(b, _upload(rows, leaf.device), 0)


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

    ``page_size`` > 0 switches the KV cache to the block-paged pool
    (``num_pages`` defaults to full fixed-cache capacity; pass less to
    hold more resident slots than the pool could serve at max_len — the
    engine preempts on exhaustion). ``prefill_chunk`` teacher-forces up
    to that many prompt tokens per engine step. ``kv_int8`` stores the
    GQA K/V pool in int8 with per-row f32 scales (not bit-exact; oracle
    attention only).

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
        if c.selection == "priority_diff":
            raise NotImplementedError(
                f"per-layer plans (selection='priority_diff') come with "
                f"{LM_TRAIN_SLICE}")
        self.cfg = (model_cfg if model_cfg is not None
                    else smoke_variant(get_config(arch)))
        cfg_canonical = self.cfg
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

        # ---- paged KV layout + chunked prefill (the reference's checks) --
        if kv_int8 and not page_size:
            raise ValueError("kv_int8 requires the paged cache "
                             "(--page-size > 0)")
        self.paging = (paging_lib.paged_layout(
            max_len, page_size, num_slots, num_pages=num_pages,
            kv_int8=kv_int8) if page_size else None)
        if self.paging is not None and c.fused_attention:
            if kv_int8:
                raise ValueError("kv_int8 has no fused-kernel path; drop "
                                 "--fused-attn (oracle dequant attention)")
            if page_size % 8:
                raise ValueError(f"--page-size {page_size} must be a "
                                 "multiple of 8 for the fused paged "
                                 "kernel (f32 sublane tiling)")
        self.alloc = (paging_lib.PageAllocator(self.paging, num_slots)
                      if self.paging is not None else None)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.preemptions = 0

        # ---- static ragged shard geometry (core/geometry.py): the step's
        # config carries the padded d_ff; params are initialized
        # canonically and expanded into the padded layout below
        self.geometry = None
        if c.geometry is not None:
            # (raises ValueError for MoE and SSM models: equal-split)
            geo = geom_lib.geometry_for_cfg(cfg_canonical, c.geometry,
                                            c.block_size)
            if not geo.is_equal:
                self.geometry = geo
                self.cfg = geom_lib.apply_geometry_cfg(cfg_canonical, geo)
                ragged_local_width(geo.padded_width, TPGroup(tp))

        wc = c.to_workload()
        self._wc = wc
        # the step's model config: the fused decode-attention kernel is a
        # model-level switch (the dense ctx=None path takes it too)
        self._step_cfg = (dataclasses.replace(self.cfg, fused_decode_attn=True)
                          if wc.fused_attention else self.cfg)
        self._cache_ax = lm_lib.cache_axes(self.cfg, paging=self.paging)
        step_cfg, cache_ax, dev = self._step_cfg, self._cache_ax, self.device
        group = TPGroup(tp)
        invalid_pos = int(paging_lib.INVALID_POS)

        def _build(static):
            if static is not None:
                static = dataclasses.replace(
                    static,
                    scope_blocks=scopes_lib.scope_block_table(self.cfg, static))

            def stepper(params, cache, tokens, pos, valid, clear, plan=None,
                        pages=None):
                # tokens/pos/valid are host [C, num_slots] arrays: C
                # chunked-prefill substeps of one engine step (C=1 is the
                # plain decode step); clear marks slots recycled this step;
                # pages is the host page table of a paged engine
                _clear_slots(cache, cache_ax, clear)
                pages_d = None if pages is None else _upload(pages, dev)
                ctx = (ControlContext(
                    static=static, bucket_by_rank=plan["bucket_by_rank"],
                    pri=plan["pri"], use_kernel=wc.use_kernel,
                    mig_src=plan.get("mig_src", ()),
                    psum_chunks=wc.psum_chunks, group=group)
                    if static is not None else None)
                p_eff = np.where(valid > 0.0, pos, invalid_pos).astype(
                    np.int32)
                tok_d = _upload(tokens, dev)
                pos_d = _upload(p_eff, dev)
                valid_d = _upload(valid, dev)
                toks = torch.zeros(tokens.shape, dtype=torch.int32,
                                   device=dev)
                # each lane's valid substeps are a prefix, so substeps past
                # the longest one have no valid lane: they would write
                # nothing and their tokens are never read — skip them
                # (a decode-only step runs one substep, not C)
                n_sub = int((valid > 0.0).sum(axis=0).max(initial=0))
                for i in range(n_sub):
                    logits, nc = lm_lib.decode_step(
                        params, step_cfg, cache, tok_d[i], pos_d[i], ctx=ctx,
                        pages=pages_d)
                    cache = _merge_invalid(cache, nc, cache_ax, valid_d[i])
                    # greedy argmax on the device: only [C, num_slots]
                    # token ids cross to the host
                    toks[i] = torch.argmax(logits, dim=-1)
                return toks, cache

            return stepper

        # ---- the control plane (build cache + controller + telemetry) ----
        self.sim_ranks = c.sim_ranks or tp
        # the latency model prices the CANONICAL workload — padded lanes
        # under a ragged geometry are inert zeros, not extra FLOPs
        self.it_model = hetero_lib.iteration_model(
            cfg_canonical, ShapeConfig("serve_model", 1, num_slots,
                                       "decode"),
            max(self.sim_ranks, 1), peak_flops=c.peak_flops, mfu=c.mfu)
        self.overhead = (hetero_lib.decode_overhead_model(
            cfg_canonical, num_slots, max_len, self.it_model,
            peak_flops=c.peak_flops,
            tile=(self.paging.page_size if self.paging is not None
                  else 128))
            if c.model_decode_overheads else None)
        self.plane = ControlPlane(
            self.cfg, wc, tp=tp, builder=_build, device=self.device,
            it_model=self.it_model, sim_ranks=self.sim_ranks,
            geometry=(self.geometry.sizes
                      if self.geometry is not None else None),
            # the controller reasons in per-rank shard blocks (the paper's
            # L_i) so migration sheds are sized to FIT a source's local
            # shard; projected sheds are additionally clamped to the real
            # group's shard when sim_ranks != tp
            controller_blocks="local", clamp_sheds=True,
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
        # params (and checkpoints) are CANONICAL; a ragged geometry
        # expands them into the zero-padded layout at load time
        # a plain assignable attribute: callers may install other weights
        self.params = init_params(cfg_canonical, seed, dtype, self.device,
                                  ckpt_dir)
        if self.geometry is not None:
            bridge.expand_ffn_modules(self.params, self.geometry)
        self.cache = lm_lib.init_cache(self.cfg, num_slots, max_len, dtype,
                                       self.device, paging=self.paging)

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
        (queue at ``max_queue``, or a request that can never fit: past
        ``max_len``, or more pages than the whole pool holds)."""
        need = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) == 0 or need > self.max_len:
            return False
        if self.paging is not None \
                and self.paging.pages_for(need) > self.paging.num_pages:
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
            if self.alloc is not None \
                    and not self.alloc.can_fit(len(self.queue[0].prompt)):
                break          # pool can't hold the prompt; wait for frees
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

    # -- page-pool bookkeeping (paged engine only) ---------------------------
    def _planned_feed(self, s: _Slot) -> int:
        """Positions this slot writes THIS step: a prefill chunk or one
        decode token."""
        P = len(s.req.prompt)
        return min(self.prefill_chunk, P - s.pos) if s.pos < P else 1

    def _preempt(self, slot: int) -> int:
        """Evict a slot back to the FRONT of the queue, returning its
        pages. Greedy decode regenerates the same tokens on re-admission;
        the TTFT clock is restored to the original eligibility time."""
        s = self.slots[slot]
        self.alloc.free_slot(slot)
        self.slots[slot] = None
        self.free.append(slot)
        self.queue.appendleft(s.req)
        self._eligible_clock[s.req.uid] = s.t_elig
        self.preemptions += 1
        return s.req.uid

    def _ensure_pages(self) -> list:
        """Grow each active slot's page list to cover this step's writes,
        preempting the most recently admitted other slot on exhaustion
        (oldest requests keep their pages). Returns the uids preempted
        this step."""
        preempted = []
        order = sorted(
            (i for i, s in enumerate(self.slots) if s is not None),
            key=lambda i: (self.slots[i].admitted_step, i))
        for i in order:
            s = self.slots[i]
            if s is None:                      # preempted earlier this pass
                continue
            while not self.alloc.ensure(i, s.pos + self._planned_feed(s) - 1):
                victims = [j for j, v in enumerate(self.slots)
                           if v is not None and j != i]
                if not victims:
                    raise RuntimeError(
                        f"page pool exhausted: slot {i} (uid "
                        f"{s.req.uid}) needs a page and no other slot "
                        "can be preempted — the pool is too small for a "
                        "single request")
                victim = max(victims,
                             key=lambda j: (self.slots[j].admitted_step, j))
                preempted.append(self._preempt(victim))
        return preempted

    def kv_cache_bytes(self) -> int:
        """Total bytes of the engine's cache tree (K/V pools or slot rows,
        int8 scales, MLA latents)."""
        return int(sum(leaf.numel() * leaf.element_size()
                       for leaf, _ in _tree_leaves_with_axes(
                           self.cache, self._cache_ax)))

    # -- one decode step -----------------------------------------------------
    def step(self) -> Dict:
        """Admit, run one engine step over all slots, harvest. On the
        paged engine, page lists first grow to cover this step's writes,
        preempting the newest-admitted slot when the pool runs dry."""
        admitted, clear = self._admit()
        preempted = self._ensure_pages() if self.alloc is not None else []

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
        proj = None
        frac = np.ones(self.sim_ranks)
        if self.controller is not None:
            times = self.plane.controller_times(chis)
            plan, plan_report = self.plane.decide(times)
            # full SEMI dispatch: the projected plan carries resize
            # buckets AND multi-source migration slots; the step is keyed
            # on the projected signature in the build cache
            step_fn, plan_arrays, proj = self.plane.dispatch(plan)
            frac = self.plane.work_frac(plan)
            latency = self.it_model.step_time(chis, frac * chunk_scale)
        else:
            step_fn, plan_arrays = self._base_step, None
            latency = (dense_latency if chunk_scale == 1.0
                       else self.it_model.step_time(
                           chis, np.ones(self.sim_ranks) * chunk_scale))

        self.plane.timer.start()
        with torch.inference_mode():
            tok_ids, self.cache = step_fn(
                self.params, self.cache, tokens_cb, pos_cb, valid_cb, clear,
                plan_arrays, pages=(self.alloc.table()
                                    if self.alloc is not None else None))
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
                if self.alloc is not None:
                    self.alloc.free_slot(i)
            else:
                s.next_token = tok

        report = {"step": self.step_count, "latency_s": latency,
                  "dense_latency_s": dense_latency, "wall_s": wall,
                  "active": sum(s is not None for s in self.slots),
                  "admitted": admitted, "completed": completed,
                  "queued": len(self.queue)}
        if preempted:
            report["preempted"] = preempted
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
            # mig_srcs/mig_shed record what EXECUTED on the real group
            # (post-projection); the controller's sim-scale intent lands
            # under planned_* — at tp=1 the two legitimately differ
            if proj is not None and proj.mig_srcs:
                report["mig_srcs"] = [int(s) for s in proj.mig_srcs]
                report["mig_shed"] = [int(m) for m in proj.mig_sheds]
            if plan_report.mig_srcs:
                report["planned_mig_srcs"] = [int(s)
                                              for s in plan_report.mig_srcs]
                report["planned_mig_shed"] = [int(m)
                                              for m in plan_report.mig_shed]
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
            and self.queue[0].arrival_step <= self.step_count
            and (self.alloc is None
                 or self.alloc.can_fit(len(self.queue[0].prompt))))
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
            free_slots=len(self.free),
            free_pages=(self.alloc.free_pages if self.alloc is not None
                        else None),
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

    # -- introspection -------------------------------------------------------
    def trace_counts(self) -> Dict[str, int]:
        """Step-build telemetry: plan signatures built vs reused. (The
        reference adds its jitted step's trace-cache size; an eager step
        is never traced, so there is no such count here.)"""
        return dict(self.plane.counts())

    def _analysis_args(self, plan=None):
        """One engine step's arguments for the analyzer: every slot feeding
        one token at its own position (a recycled slot cleared), the
        engine's own params and cache (hot state, argnum 1)."""
        B, C = self.num_slots, self.prefill_chunk
        tokens = np.zeros((C, B), np.int32)
        tokens[0] = np.arange(B) + 3
        pos = np.full((C, B), paging_lib.INVALID_POS, np.int32)
        pos[0] = np.arange(B) + 2
        valid = np.zeros((C, B), np.float32)
        valid[0] = 1.0
        clear = np.zeros((B,), np.float32)
        clear[0] = 1.0
        pages = self.alloc.table() if self.alloc is not None else None
        return (self.params, self.cache, tokens, pos, valid, clear, plan,
                pages)

    def analysis_cases(self, step: str = "serve_engine_step"):
        """Analyzer cases for THIS engine's base step (repro_torch.analysis):
        the exact step ``step()`` drives when no controller runs, with the
        KV cache declared hot state (argnum 1), so R2 proves it is updated
        in place."""
        from repro_torch.analysis.registry import TraceCase

        def fn(*args):
            with torch.inference_mode():
                return self._base_step(*args[:7], pages=args[7])
        return [TraceCase(
            step=step, name=f"base_tp{self.tp}", fn=fn,
            args=self._analysis_args(), state_argnums=(1,),
            signature=f"serve_base_tp{self.tp}")]

    def analysis_decode_cases(self, spellings, *, bucket: int = 1,
                              mig_src=(), name: str = "", expect=None):
        """Analyzer cases for the controlled serve step of one plan
        signature, built by the plane's builder directly (not through its
        build cache, which would hand back one object for every spelling)
        from each ``(label, PlanStatic)`` of ``spellings``: the first is the
        case, the rest are its retraces (R1). Every rank at ``bucket``;
        ``mig_src`` the source rank of each migration slot."""
        from repro_torch.analysis.registry import TraceCase
        plan = {"bucket_by_rank": np.full((self.tp,), bucket, np.int32),
                "mig_src": np.asarray(mig_src, np.int32),
                "pri": self.plane.identity_pri}

        def step_fn(static):
            built = self.plane.builder(static)

            def fn(*args):
                with torch.inference_mode():
                    return built(*args[:7], pages=args[7])
            return fn
        args = self._analysis_args(plan)
        (_, first), rest = spellings[0], spellings[1:]
        return [TraceCase(
            step="serve_decode_step",
            name=name or f"controlled_tp{self.tp}",
            fn=step_fn(first), args=args, state_argnums=(1,),
            expect=dict(expect or {}),
            signature=first.canonical().signature_str(),
            retrace=tuple((f"{label}-spelling", step_fn(st), args)
                          for label, st in rest))]


# ---------------------------------------------------------------------------
# Fixed-batch engine (the reference's lockstep loop, kept as the equivalence
# baseline: slot recycling and cluster routing are held against it)
# ---------------------------------------------------------------------------


class FixedBatchEngine:
    """Holds params and serves fixed batches one token a step over a slot
    cache, with the model's default attention (not the fused switch).

    Beside the reference's arguments it takes the port's ``device``
    (default ``"cuda"``), ``model_cfg`` (a full-width config in place of
    the smoke variant) and ``param_dtype``; its weights come from
    :func:`init_params`, as :class:`ServeEngine`'s do."""

    def __init__(self, arch: str, batch: int, max_len: int,
                 ckpt_dir: Optional[str] = None, seed: int = 0, *,
                 device="cuda", model_cfg: Optional[ModelConfig] = None,
                 param_dtype: str = "float32"):
        self.cfg = (model_cfg if model_cfg is not None
                    else smoke_variant(get_config(arch)))
        if param_dtype not in _DTYPES:
            raise ValueError(f"param_dtype must be one of {sorted(_DTYPES)}")
        self.device = resolve_device(device)
        self.batch = batch
        self.max_len = max_len
        self.dtype = _DTYPES[param_dtype]
        self.params = init_params(self.cfg, seed, self.dtype, self.device,
                                  ckpt_dir)

    def generate(self, prompts: np.ndarray, gen_len: int,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """prompts [B, P] int32 -> [B, P+gen_len] greedy continuations
        (after an EOS a row repeats it; all rows done ends the loop)."""
        B, P = prompts.shape
        if B != self.batch or P + gen_len > self.max_len:
            raise ValueError(f"prompts {prompts.shape} + {gen_len} tokens "
                             f"do not fit batch {self.batch}, max_len "
                             f"{self.max_len}")
        dev = self.device
        cache = lm_lib.init_cache(self.cfg, B, self.max_len, self.dtype, dev)
        out = [np.asarray(prompts[:, 0], np.int32)]
        done = np.zeros((B,), bool)
        with torch.inference_mode():
            for t in range(P + gen_len - 1):
                logits, cache = lm_lib.decode_step(
                    self.params, self.cfg, cache, _upload(out[-1], dev),
                    torch.full((B,), t, dtype=torch.int32, device=dev))
                if t + 1 < P:
                    nxt = np.asarray(prompts[:, t + 1], np.int32)
                else:
                    nxt = torch.argmax(logits, dim=-1).to(
                        torch.int32).cpu().numpy()
                    if eos_id is not None:
                        done |= nxt == eos_id
                        nxt = np.where(done, eos_id or 0, nxt).astype(
                            np.int32)
                out.append(nxt)
                if eos_id is not None and done.all():
                    break
        return np.stack(out, axis=1)


# The reference's second name for the same engine, kept so the port's
# public names match the reference's.
DecodeEngine = FixedBatchEngine


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
    ap.add_argument("--max-sources", type=int, default=3,
                    help="concurrent migration slots (semi mode)")
    ap.add_argument("--beta-policy", default="lossless",
                    choices=["lossless", "eq2"],
                    help="semi mission split: lossless migrates the full "
                         "offset volume (token-exact); eq2 balances "
                         "migration vs resize cost per Eq.(2)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="pruned products through the CUDA kernels")
    ap.add_argument("--fused-attn", action="store_true",
                    help="decode attention through the fused CUDA kernel")
    ap.add_argument("--psum-chunks", type=int, default=1,
                    help="split the controlled epilogue all-reduce into "
                         "this many sums")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the newest committed checkpoint's params")
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
    ap.add_argument("--geometry", default=None,
                    help="static ragged TP shard geometry: per-rank FFN "
                         "block counts 'a,b,...' (DESIGN_SHARDING.md)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="block-paged KV cache page size in tokens "
                         "(0 = fixed per-slot cache); with --fused-attn "
                         "must be a multiple of 8")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pages in the shared pool (default: every slot "
                         "at max_len); fewer makes the engine preempt")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantize the paged K/V pools (per-row "
                         "scales; oracle attention path only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless you ask for cpu)")
    args = ap.parse_args(argv)

    control = ControlConfig(
        mode=args.control, hetero_kind=args.hetero, chi=args.chi,
        sim_ranks=args.sim_ranks, max_sources=args.max_sources,
        beta_policy=args.beta_policy, use_kernel=args.use_kernel,
        fused_attention=args.fused_attn, psum_chunks=args.psum_chunks,
        times=args.times, trace_in=args.trace_in, trace_out=args.trace_out,
        geometry=geom_lib.parse_geometry_arg(args.geometry, args.tp))
    eng = ServeEngine(args.arch, num_slots=args.slots,
                      max_len=args.prompt_len + args.gen_len, tp=args.tp,
                      ckpt_dir=args.ckpt_dir, control=control, page_size=args.page_size,
                      prefill_chunk=args.prefill_chunk,
                      kv_int8=args.kv_int8, num_pages=args.num_pages,
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
    migrated = sum(1 for h in eng.history if h.get("mig_srcs"))
    print(f"trace counts: {eng.trace_counts()}; migrating steps "
          f"{migrated}; preemptions {eng.preemptions}")


# ---------------------------------------------------------------------------
# static-analysis registration (repro_torch.analysis)
# ---------------------------------------------------------------------------

from repro_torch.analysis import registry as _analysis  # noqa: E402


def _an_engine(env, control):
    return ServeEngine("yi-6b", num_slots=2, max_len=16, control=control,
                       device=env.device)


def _an_serve_engine_cases(env):
    eng = _an_engine(env, ControlConfig(fused_attention=True))
    try:
        return eng.analysis_cases()
    finally:
        eng.close()


def _an_decode_cases(env):
    cases = []
    # ZERO at tp 1, and SEMI at tp 4 with rank 0 the source of a 2-block
    # shed (block 16: 8 blocks a rank of Yi-6B smoke's 512-wide FFN), the
    # path of the migrating serve step: one grouped broadcast per FFN
    # layer, each psum in rank order
    for tp, name, control, plan in (
            (1, "", ControlConfig(
                mode="zero", hetero_kind="contention", chi=4.0, sim_ranks=8,
                use_kernel=True, fused_attention=True), {}),
            (4, "controlled_tp4_semi", ControlConfig(
                mode="semi", hetero_kind="contention", chi=4.0, sim_ranks=8,
                block_size=16, use_kernel=True, fused_attention=True),
             dict(bucket=0, mig_src=(0,),
                  expect={"grouped_bcast": {"count": 2}}))):
        eng = ServeEngine("yi-6b", num_slots=2, max_len=16, tp=tp,
                          control=control, device=env.device)
        try:
            # two spellings of one canonical plan signature (R1)
            st = eng.plane.static
            cases += eng.analysis_decode_cases([
                ("mig_shed", dataclasses.replace(st, mig_shed=(2,))),
                ("mig_blocks", dataclasses.replace(st, mig_blocks=2))],
                name=name, **plan)
        finally:
            eng.close()
    return cases


_analysis.register("serve_engine_step", _an_serve_engine_cases)
_analysis.register("serve_decode_step", _an_decode_cases)


if __name__ == "__main__":
    main()
