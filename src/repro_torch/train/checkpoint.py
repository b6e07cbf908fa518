"""Crash-consistent checkpointing — the counterpart of
``repro/train/checkpoint.py``, with the same on-disk layout.

A checkpoint is one directory holding two files:

  * ``params.npz``     the flat-key arrays: the params tree under
                       ``params/``, the optimizer state under ``opt/``, and
                       any auxiliary arrays (telemetry counters) under
                       ``aux/``.
  * ``manifest.json``  step, key list, structure strings, the resume cursor,
                       and a SHA-256 content checksum of ``params.npz``.
                       **The manifest is the commit point.**

A tree is nested dicts (flattened in sorted key order), lists and tuples
(``NamedTuple``s included) of leaves: torch tensors, numpy arrays or
scalars. The flat keys are the JAX package's for the same tree, so the
trainer's ``[{name: tensor} per layer]`` parameters and its
``OptimizerState`` flatten to the reference's ``params/<layer>/<name>``,
``opt/0`` and ``opt/1/m/<layer>/<name>`` keys. Tensors are read to the host
here, one ``.detach().cpu()`` copy each; ``load_checkpoint`` returns numpy
arrays and leaves their placement to the caller.

Structure strings: the reference records JAX's ``PyTreeDef`` strings in
``treedef``/``opt_treedef``, which cannot be produced without JAX. The port
writes its own deterministic string in their place — the JSON list of
``[key, shape, dtype]`` of the tree's leaves, in flattening order — and
validates against the template's string. The npz keys, the cursor and the
arrays are the reference's; the structure strings are not, so a checkpoint
of one package does not load in the other.

Atomicity: each file is written to a same-directory temp name, flushed +
fsynced, then ``os.replace``d into place — and the manifest (which names
the checksum of the already-final npz) is replaced *last*. A crash at any
point leaves either (a) no manifest — the directory is not a checkpoint and
``load_latest_checkpoint`` skips it, or (b) a complete, self-validating
pair.

Validation (``load_checkpoint``) raises
:class:`~repro_torch.faults.CheckpointError` — never an ``assert`` — for an
unreadable manifest, an unknown checksum algorithm, a checksum mismatch
(checked before any array is parsed), npz keys that differ from the
manifest's, a key set or structure string that differs from the template's,
and a missing optimizer state the caller asked for.
``load_latest_checkpoint`` walks ``ckpt-*`` directories newest-first and
falls back past corrupt ones to the previous good checkpoint, logging each
rejection.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.faults.errors import CheckpointError

log = logging.getLogger("repro_torch.checkpoint")

MANIFEST_VERSION = 2
_ARRAYS = "params.npz"
_MANIFEST = "manifest.json"
_CKPT_RE = re.compile(r"^ckpt-(\d{8,})$")


def _flatten(tree, prefix=""):
    """``{key: leaf}`` with the reference's keys (dict keys sorted)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _meta(leaf) -> list:
    """``[shape, dtype]`` of a leaf, without reading a tensor's data."""
    if isinstance(leaf, torch.Tensor):
        return [list(leaf.shape), str(leaf.dtype).removeprefix("torch.")]
    a = np.asarray(leaf)
    return [list(a.shape), str(a.dtype)]


def _structure(tree) -> str:
    """The port's structure string: ``[key, shape, dtype]`` per leaf."""
    return json.dumps([[k, *_meta(v)] for k, v in _flatten(tree).items()])


def _rebuild(tree, leaves_by_key, prefix=""):
    """Template-shaped rebuild; NamedTuples (OptimizerState) reconstruct
    through their field constructor, plain tuples through ``tuple``."""
    if isinstance(tree, dict):
        return {
            k: _rebuild(tree[k], leaves_by_key, f"{prefix}{k}/") for k in tree
        }
    if isinstance(tree, (list, tuple)):
        items = [
            _rebuild(v, leaves_by_key, f"{prefix}{i}/")
            for i, v in enumerate(tree)
        ]
        if isinstance(tree, tuple):
            if hasattr(tree, "_fields"):  # NamedTuple
                return type(tree)(*items)
            return tuple(items)
        return items
    return leaves_by_key[prefix.rstrip("/")]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _atomic_write_bytes(path: str, write_fn) -> None:
    """Write via same-directory temp + fsync + ``os.replace``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@dataclass
class Checkpoint:
    """One loaded, validated checkpoint (arrays as numpy)."""

    params: object
    step: int
    opt_state: object = None
    cursor: dict = field(default_factory=dict)
    extra: dict = field(default_factory=dict)
    aux: dict = field(default_factory=dict)  # name -> np.ndarray
    path: str = ""


def save_checkpoint(
    path: str,
    params,
    step: int,
    extra: dict | None = None,
    opt_state=None,
    cursor: dict | None = None,
    aux_arrays: dict | None = None,
) -> None:
    """Write one crash-consistent checkpoint into directory ``path``.

    ``opt_state`` (any tree — the port's ``OptimizerState``) and
    ``aux_arrays`` (flat name -> array, e.g. telemetry counters) ride in the
    same npz under their own prefixes; ``cursor`` is the JSON-able resume
    position (see ``Trainer.save_checkpoint``). The manifest, containing the
    npz checksum, is replaced last: it is the commit point.
    """
    os.makedirs(path, exist_ok=True)
    flat = {f"params/{k}": _to_numpy(v) for k, v in _flatten(params).items()}
    if opt_state is not None:
        flat.update({f"opt/{k}": _to_numpy(v)
                     for k, v in _flatten(opt_state).items()})
    for name, arr in (aux_arrays or {}).items():
        flat[f"aux/{name}"] = np.asarray(arr)

    arrays_path = os.path.join(path, _ARRAYS)
    _atomic_write_bytes(arrays_path, lambda f: np.savez(f, **flat))
    manifest = {
        "version": MANIFEST_VERSION,
        "step": int(step),
        "keys": sorted(flat.keys()),
        "checksum": f"sha256:{_sha256(arrays_path)}",
        "treedef": _structure(params),
        "opt_treedef": (
            _structure(opt_state) if opt_state is not None else None
        ),
        "cursor": cursor or {},
        "extra": extra or {},
    }
    payload = json.dumps(manifest, indent=2, sort_keys=True).encode("utf-8")
    _atomic_write_bytes(
        os.path.join(path, _MANIFEST), lambda f: f.write(payload)
    )


def load_checkpoint(
    path: str, params_like, opt_state_like=None
) -> Checkpoint:
    """Validate + restore one checkpoint directory into template structures.

    Every integrity violation raises :class:`CheckpointError` (checksum
    first — before any array is parsed — then key set, then structure).
    ``opt_state_like`` is optional: when omitted, optimizer arrays in the
    file are ignored; when given but the checkpoint has none, that is an
    error (a resume that silently reinitializes Adam moments is not a
    resume).
    """
    manifest_path = os.path.join(path, _MANIFEST)
    arrays_path = os.path.join(path, _ARRAYS)
    if not os.path.exists(manifest_path):
        raise CheckpointError(f"{path}: no manifest — not a checkpoint")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"{path}: unreadable manifest: {e}") from e

    declared = manifest.get("checksum", "")
    if declared:
        algo, _, want = declared.partition(":")
        if algo != "sha256":
            raise CheckpointError(
                f"{path}: unknown checksum algorithm {algo!r}"
            )
        try:
            got = _sha256(arrays_path)
        except OSError as e:
            raise CheckpointError(f"{path}: unreadable arrays: {e}") from e
        if got != want:
            raise CheckpointError(
                f"{path}: content checksum mismatch — manifest says "
                f"sha256:{want[:12]}…, file is sha256:{got[:12]}… "
                "(corrupt or torn write)"
            )

    try:
        with np.load(arrays_path) as npz:
            data = {k: npz[k] for k in npz.files}
    except Exception as e:  # any unreadable npz is one integrity failure
        raise CheckpointError(f"{path}: unreadable arrays: {e}") from e
    file_keys = sorted(data)
    if file_keys != sorted(manifest.get("keys", [])):
        raise CheckpointError(
            f"{path}: npz key set does not match the manifest key list"
        )

    template_keys = sorted(
        f"params/{k}" for k in _flatten(params_like).keys()
    )
    have_params = sorted(k for k in file_keys if k.startswith("params/"))
    if have_params != template_keys:
        missing = set(template_keys) - set(have_params)
        surplus = set(have_params) - set(template_keys)
        raise CheckpointError(
            f"{path}: params tree mismatch vs restore template "
            f"(missing {sorted(missing)[:4]}, surplus {sorted(surplus)[:4]})"
        )
    if manifest.get("treedef") != _structure(params_like):
        raise CheckpointError(
            f"{path}: manifest treedef does not match the restore template "
            "(different model structure?)"
        )

    leaves = {k[len("params/"):]: data[k] for k in have_params}
    params = _rebuild(params_like, leaves)

    opt_state = None
    if opt_state_like is not None:
        opt_keys = sorted(
            f"opt/{k}" for k in _flatten(opt_state_like).keys()
        )
        have_opt = sorted(k for k in file_keys if k.startswith("opt/"))
        if not have_opt:
            raise CheckpointError(
                f"{path}: checkpoint carries no optimizer state but the "
                "caller asked to restore one"
            )
        if have_opt != opt_keys:
            raise CheckpointError(
                f"{path}: optimizer-state tree mismatch vs template"
            )
        if manifest.get("opt_treedef") != _structure(opt_state_like):
            raise CheckpointError(
                f"{path}: manifest opt_treedef does not match the template"
            )
        opt_leaves = {k[len("opt/"):]: data[k] for k in have_opt}
        opt_state = _rebuild(opt_state_like, opt_leaves)

    aux = {
        k[len("aux/"):]: data[k]
        for k in file_keys
        if k.startswith("aux/")
    }
    return Checkpoint(
        params=params,
        step=int(manifest["step"]),
        opt_state=opt_state,
        cursor=dict(manifest.get("cursor", {})),
        extra=dict(manifest.get("extra", {})),
        aux=aux,
        path=path,
    )


# --------------------------------------------------------------------- #
# versioned checkpoint directories: ckpt-<step> under one root
# --------------------------------------------------------------------- #
def checkpoint_name(step: int) -> str:
    return f"ckpt-{int(step):08d}"


def list_checkpoints(root: str) -> list[tuple[int, str]]:
    """(step, path) for every ``ckpt-*`` directory under ``root``, ascending.

    Directories without the naming pattern (including leftover temp files)
    are ignored; a listed directory may still fail validation at load time.
    """
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _CKPT_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


def load_latest_checkpoint(
    root: str, params_like, opt_state_like=None
) -> Checkpoint | None:
    """Newest valid checkpoint under ``root`` (previous-good fallback).

    Walks candidates newest-first; a candidate that fails validation is
    logged (warning, with the reason) and skipped — a corrupted latest
    checkpoint therefore resumes from the one before it. Returns ``None``
    when no candidate exists at all; raises :class:`CheckpointError` when
    candidates exist but every one is corrupt (silently starting from
    scratch would masquerade as a resume).
    """
    candidates = list_checkpoints(root)
    if not candidates:
        return None
    rejected = []
    for _, path in reversed(candidates):
        try:
            ck = load_checkpoint(path, params_like, opt_state_like)
        except CheckpointError as e:
            log.warning("skipping corrupt checkpoint %s: %s", path, e)
            rejected.append((path, str(e)))
            continue
        if rejected:
            log.warning(
                "resumed from %s after rejecting %d newer checkpoint(s)",
                path, len(rejected),
            )
        return ck
    raise CheckpointError(
        f"{root}: all {len(rejected)} checkpoint(s) failed validation: "
        + "; ".join(f"{p}: {r}" for p, r in rejected)
    )
