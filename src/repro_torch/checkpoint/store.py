"""Checkpointing: a tree of numpy arrays <-> npz with a structure manifest
(port of ``repro.checkpoint.store``).

Single-file npz per step plus a JSON manifest of the tree's flat keys,
shapes and dtypes. The files are the reference's: a checkpoint written by
either package restores in the other.

Durability contract (crash-safe by construction), as in the reference:

* both files are written to a temp path in the same directory and moved
  into place with ``os.replace`` (atomic on POSIX) — a crash mid-write
  leaves a ``.tmp`` orphan, never a torn checkpoint;
* the manifest is written AFTER the npz and acts as the commit marker:
  :func:`latest_step` only counts steps whose npz **and** manifest both
  exist, so a crash between the two renames leaves an ignorable orphan
  npz rather than a corrupt "latest" checkpoint;
* :func:`restore` validates dtypes/shapes against the manifest before
  touching the model and always closes the npz handle.

Trees are nested dicts, lists, tuples and named tuples with numpy leaves
(``None`` is an empty subtree, as a JAX pytree has it). Flat keys join
the path components with ``/`` exactly as the reference's
``tree_flatten_with_path`` keys do: a dict key or a named tuple's field
name escaped, a list or tuple index as its number. Literal ``/`` (and
``\\``) inside dict keys are escaped so distinct paths never collide on
one flat key.

Leaves must be numpy's own numeric or boolean types: a leaf numpy cannot
represent without an extension (bfloat16, a torch tensor of it) is
refused with its key named, never widened in silence. The trainer holds
f32; the engines cast to their parameter dtype after the load.

The full-train-state layout (params + optimizer moments + control-plane
state in one tree, step/data-position/RNG streams in the manifest
``extra``) is assembled by the trainer; :func:`restore`'s ``prefix``
selects one subtree of it, and :func:`load_params` loads either that
layout or a legacy params-only checkpoint.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# manifest "extra" layout tag for full-train-state checkpoints
TRAIN_STATE_LAYOUT = "train_state_v1"

# numpy dtype kinds a checkpoint holds: bool, signed / unsigned int,
# float, complex (an extension type such as bfloat16 has kind "V")
_NATIVE_KINDS = "biufc"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path component, child) pairs of an inner node, in the order the
    reference's flatten visits them (dict keys sorted); None for a leaf."""
    if isinstance(node, dict):
        return [(_escape(str(k)), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(_escape(f), getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _leaves_with_keys(tree, prefix: str = ""):
    """(flat key, leaf) for every leaf of ``tree``; ``None`` has none."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for comp, child in kids:
        yield from _leaves_with_keys(child,
                                     f"{prefix}/{comp}" if prefix else comp)


def _as_numpy(key: str, leaf) -> np.ndarray:
    if hasattr(leaf, "detach") and hasattr(leaf, "numpy"):   # a tensor
        try:
            leaf = leaf.detach().cpu().numpy()
        except TypeError as e:
            raise TypeError(
                f"checkpoint leaf {key!r}: {leaf.dtype} has no numpy "
                "dtype; cast it (the trainer saves float32)") from e
    arr = np.asarray(leaf)
    if arr.dtype.kind not in _NATIVE_KINDS:
        raise TypeError(
            f"checkpoint leaf {key!r} has dtype {arr.dtype}, which numpy "
            "cannot load without an extension; cast it to a numpy type "
            "(the trainer saves float32)")
    return arr


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {k: _as_numpy(k, v) for k, v in _leaves_with_keys(tree)}


def _escape(component: str) -> str:
    """Escape the path separator inside a single key component, so a dict
    key containing ``/`` cannot collide with genuine nesting
    ({"a/b": x} vs {"a": {"b": x}})."""
    return component.replace("\\", "\\\\").replace("/", "\\/")


def _split_key(key: str) -> list:
    """Split a flat key on UNESCAPED ``/`` and unescape the components."""
    parts, cur, i = [], [], 0
    while i < len(key):
        c = key[i]
        if c == "\\" and i + 1 < len(key):
            cur.append(key[i + 1])
            i += 2
            continue
        if c == "/":
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    parts.append("".join(cur))
    return parts


def _npz_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def _manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.json")


def _atomic_write(path: str, write_fn) -> None:
    """Write via a same-directory temp file + ``os.replace`` so readers
    never observe a partially written checkpoint file."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save(directory: str, step: int, tree: Any, extra: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten_with_paths(tree)
    path = _npz_path(directory, step)
    # OVERWRITING a step: retract the old commit marker first, so a crash
    # between the new npz landing and its new manifest landing leaves a
    # manifest-less orphan (correctly skipped) — never a new npz silently
    # paired with the previous save's manifest/extra state.
    try:
        os.unlink(_manifest_path(directory, step))
    except FileNotFoundError:
        pass
    _atomic_write(path, lambda f: np.savez(f, **flat))
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "extra": extra or {},
    }
    # the manifest commits the checkpoint: written (atomically) only after
    # the npz is durably in place, and required by latest_step/restore
    _atomic_write(_manifest_path(directory, step),
                  lambda f: f.write(json.dumps(manifest, indent=1)
                                    .encode("utf-8")))
    return path


def latest_step(directory: str) -> Optional[int]:
    """Newest COMMITTED step: an npz without its manifest is a torn write
    (crash between the data and the commit marker) and is skipped."""
    if not os.path.isdir(directory):
        return None
    steps = [int(f[5:13]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".npz")
             and os.path.exists(_manifest_path(directory, int(f[5:13])))]
    return max(steps) if steps else None


def read_manifest(directory: str, step: int) -> dict:
    path = _manifest_path(directory, step)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint step {step} in {directory} has no manifest — "
            "either it predates the manifest format or its write was "
            "interrupted; re-save or delete the orphan npz")
    with open(path) as f:
        return json.load(f)


def _rebuild(like, leaves) -> Any:
    """``like``'s structure with its leaves taken in flatten order."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}        # the template's key order
    vals = [_rebuild(c, leaves) for _, c in kids]
    return type(like)(*vals) if _is_namedtuple(like) else type(like)(vals)


def restore(directory: str, step: int, like: Any, *,
            prefix: Optional[str] = None) -> Any:
    """Restore into the structure of ``like`` (a tree of numpy arrays, or
    of anything with ``shape`` and a numpy ``dtype``); each leaf is cast
    to its template's dtype.

    Validates every leaf against the manifest (key present, dtype and
    shape match what was written) before materializing, so a truncated or
    mismatched checkpoint fails with an actionable error instead of
    feeding garbage into the model. ``prefix`` selects a subtree of a
    larger saved tree (e.g. ``"params"`` of a full-train-state
    checkpoint).
    """
    manifest = read_manifest(directory, step)
    m_shapes, m_dtypes = manifest["shapes"], manifest["dtypes"]
    want = []
    for key, leaf in _leaves_with_keys(like):
        if prefix:
            key = f"{_escape(prefix)}/{key}" if key else _escape(prefix)
        if key not in m_shapes:
            raise KeyError(
                f"checkpoint {directory} step {step} missing leaf {key!r} "
                f"(manifest has {len(m_shapes)} keys"
                + (f" under a different layout; prefix={prefix!r}" if prefix
                   else "") + ")")
        if tuple(m_shapes[key]) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {tuple(m_shapes[key])} vs "
                f"model {tuple(leaf.shape)} — architecture/shape config "
                "changed since this checkpoint was written")
        want.append((key, leaf))

    leaves = []
    with np.load(_npz_path(directory, step)) as data:
        for key, leaf in want:
            if key not in data:
                raise KeyError(
                    f"checkpoint npz missing leaf {key!r} declared by its "
                    "manifest — the npz is truncated/corrupt; restore from "
                    "an earlier step")
            arr = data[key]
            if str(arr.dtype) != m_dtypes[key]:
                raise ValueError(
                    f"dtype mismatch for {key}: npz {arr.dtype} vs manifest "
                    f"{m_dtypes[key]} — the checkpoint pair is inconsistent")
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs model "
                    f"{leaf.shape}")
            leaves.append(arr.astype(leaf.dtype))
    return _rebuild(like, iter(leaves))


def load_arrays(directory: str, step: int,
                prefix: Optional[str] = None) -> Dict[str, Any]:
    """Load a (sub)tree of a checkpoint as a NESTED dict of numpy arrays,
    without a ``like`` template — used for control-plane state, whose
    structure (e.g. which priority scopes exist) is data-dependent."""
    esc = _escape(prefix) + "/" if prefix else ""
    out: Dict[str, Any] = {}
    with np.load(_npz_path(directory, step)) as data:
        for key in data.files:
            if prefix and not key.startswith(esc):
                continue
            parts = _split_key(key[len(esc):])
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return out


def load_params(directory: str, step: int, like: Any) -> Any:
    """Restore model params from either layout: a full-train-state
    checkpoint (params live under the ``params/`` subtree) or a legacy
    params-only checkpoint."""
    manifest = read_manifest(directory, step)
    full = manifest.get("extra", {}).get("layout") == TRAIN_STATE_LAYOUT
    return restore(directory, step, like,
                   prefix="params" if full else None)


def load_latest_params(directory: str, like: Any, retries: int = 2):
    """Warm-spare promotion path: ``(step, params)`` of the newest
    COMMITTED checkpoint, tolerant of a writer racing the read.

    A trainer overwriting a step retracts its manifest before rewriting
    the npz (see :func:`save`), so a reader that scanned just before the
    retraction can pick a step whose manifest vanishes by the time it
    opens it. Readers of a *different* process must not crash on that
    benign race: re-scan and fall back to the previous committed step.
    Returns ``(None, None)`` when the directory holds no committed
    checkpoint at all.
    """
    skip: set = set()
    for _ in range(max(1, retries + 1)):
        steps = [] if not os.path.isdir(directory) else sorted(
            (int(f[5:13]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".npz")
             and int(f[5:13]) not in skip
             and os.path.exists(_manifest_path(directory, int(f[5:13])))),
            reverse=True)
        if not steps:
            return None, None
        step = steps[0]
        try:
            return step, load_params(directory, step, like)
        except FileNotFoundError:
            # manifest retracted between the scan and the read — the
            # writer is mid-overwrite of this step; try the next-newest
            skip.add(step)
    raise RuntimeError(
        f"checkpoint directory {directory} kept changing under the "
        f"reader ({retries + 1} attempts) — is a writer looping?")
