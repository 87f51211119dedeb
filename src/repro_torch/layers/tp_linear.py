"""Tensor-parallel linear layers with flexible workload control (port of
``repro.layers.tp_linear`` for one rank).

Two execution paths per op, as in the reference:

* **plain** (ctx is None, or the scope is not controlled): dense
  products.
* **controlled**: the rank applies its γ-bucket — ZERO-resizing over its
  keep-first priority list ``pri``::

      [ keep kc_b | pruned ]

  The reference runs this inside ``shard_map`` with a ``lax.switch`` over
  the buckets, and adds multi-source migration at ``tp > 1``. This port
  covers ``tp == 1``: the bucket is a host integer, the branch a Python
  pick, and the epilogue all-reduce over one rank is the identity.
  ``tp > 1``, migration sources and a ragged geometry raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import resizing
from repro_torch.core.workload import PlanStatic, keep_blocks_for_bucket

TRAINING_SLICE = ("the training slice (ROADMAP.md, queue A: ViT TP training "
                  "under SEMI, with multi-rank emulation and migration)")


@dataclasses.dataclass
class ControlContext:
    """Plan handed to the controlled layers for one step.

    bucket_by_rank: [e] int32 host tensor (the bucket is read as a Python
                    integer to pick a branch)
    pri:            scope -> [nb] ("col") / [e, nb_loc] ("row") int32,
                    on the device of the weights

    The reference's migration sources (``mig_src``) and chunked epilogue
    (``psum_chunks``) have nothing to act on at one rank; they come with
    the training slice.
    """

    static: PlanStatic
    bucket_by_rank: torch.Tensor
    pri: Dict[str, torch.Tensor]
    use_kernel: bool = False
    _keep: Dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        # this rank's bucket as a host integer, read once per plan
        self.bucket = int(self.bucket_by_rank[0])

    def pri_list(self, scope: str) -> torch.Tensor:
        """This rank's keep-first list for a scope."""
        pri = self.pri[scope]
        return pri if pri.ndim == 1 else pri[0]

    def keep(self, scope: str, kc: int) -> torch.Tensor:
        """Sorted kept block ids of a scope at keep count ``kc``, computed
        once per plan and shared by every layer."""
        key = (scope, kc)
        if key not in self._keep:
            self._keep[key] = resizing.sorted_prefix(self.pri_list(scope), kc)
        return self._keep[key]

    def check_supported(self) -> None:
        st = self.static
        if st.tp_size != 1:
            raise NotImplementedError(
                f"controlled layers at tp={st.tp_size} come with "
                f"{TRAINING_SLICE}")
        if st.mig_sheds:
            raise NotImplementedError(
                f"migration (mig_shed {st.mig_sheds}) comes with "
                f"{TRAINING_SLICE}")
        if len(set(st.geometry)) > 1:
            raise NotImplementedError(
                f"a ragged shard geometry ({st.geometry}) comes with "
                f"{TRAINING_SLICE}")


# ---------------------------------------------------------------------------
# Controlled projection (resizing only) — attention projections
# ---------------------------------------------------------------------------


def controlled_proj(x: torch.Tensor, w: torch.Tensor,
                    ctx: Optional[ControlContext], scope: str, *,
                    split: str) -> torch.Tensor:
    """TP linear with ZERO-resizing on the contraction dim.

    split="col": w [K, N] would be split on N over TP, x replicated.
    split="row": w [K, N] would be split on K, the output all-reduced.
    At one rank both are the same product; the split only selects which
    priority layout (global [nb] or per-rank [e, nb]) the scope carries.
    """
    if split not in ("col", "row"):
        raise ValueError(f"split must be 'col' or 'row', got {split!r}")
    if ctx is None or scope not in ctx.pri:
        return x @ w
    ctx.check_supported()
    st = ctx.static
    return resizing.switched_matmul(
        x, w, ctx.pri_list(scope), ctx.bucket,
        buckets=st.buckets, block=st.block_for(scope),
        use_kernel=ctx.use_kernel, keep_for=lambda kc: ctx.keep(scope, kc))


# ---------------------------------------------------------------------------
# Controlled FFN pair (resizing)
# ---------------------------------------------------------------------------


def controlled_ffn(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                   ctx: Optional[ControlContext], scope: str,
                   act_fn: Callable,
                   w_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FFN pair y = act(x@w_up[,·gate]) @ w_down under workload control.

    The intermediate H blocks are the controlled workload unit: the rank
    keeps the first kc blocks of its priority list for its bucket.
    """
    if ctx is None or scope not in ctx.pri:
        h = x @ w_up
        h = act_fn(x @ w_gate) * h if w_gate is not None else act_fn(h)
        return h @ w_down
    ctx.check_supported()
    st = ctx.static
    blk = st.block_for(scope)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    nb = w_up.shape[1] // blk
    kc = max(1, min(keep_blocks_for_bucket(st.buckets[ctx.bucket], nb), nb))
    if kc >= nb:
        # dense shortcut: keeping every block, the gather is an identity
        # copy — skip it (γ = 0 runs the true dense pair)
        h = x2 @ w_up
        h = act_fn(x2 @ w_gate) * h if w_gate is not None else act_fn(h)
        y = h @ w_down
    else:
        y = resizing.resized_ffn(x2, w_up, w_down, ctx.keep(scope, kc),
                                 act_fn, w_gate, block=blk,
                                 use_kernel=ctx.use_kernel)
    return y.reshape(*lead, w_down.shape[1])
