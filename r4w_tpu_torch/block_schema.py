"""Typed per-block parameter metadata.

PyTorch counterpart of ``r4w_tpu.block_schema``: a forms-quality schema
for every registry block, one dict per parameter with name, type, default,
required, role (stream input vs configuration) and a doc line mined from
the callable's docstring. The reference hand-writes this as 5,148 lines of
crates/r4w-gui/src/views/block_metadata.rs; here it is harvested
mechanically from the signatures the port's blocks carry, so it can never
drift from the code.

Consumed by `BlockRegistry.param_schema` and the pipeline wizard's typed
forms.
"""

from __future__ import annotations

import inspect
import re

# parameter names that are stream INPUTS (wired from upstream nodes in
# the wizard) rather than configuration the user types in
_INPUT_NAMES = frozenset({
    "x", "y", "iq", "rx", "tx", "signal", "samples", "bits", "data",
    "audio", "symbols", "stream", "frames", "block", "llr", "soft",
    "a", "b", "input", "baseband", "payload", "vib", "echo", "cube",
    "trace_db", "waveform", "measurements", "mixtures", "emg", "ecg",
    "eeg", "key", "power", "spec", "spectrum", "psd", "phase", "env",
    "pcm16", "nibbles", "coded", "received", "pulse_heights",
    "snapshots", "levels",
})

_TYPE_NAMES = {
    int: "int", float: "float", bool: "bool", str: "str",
    bytes: "bytes", complex: "complex",
}
# annotations that name an array type: a tensor or a numpy array is "array",
# as an unannotated stream parameter is
_ARRAY_TYPES = frozenset({"torch.Tensor", "Tensor", "np.ndarray", "numpy.ndarray", "ndarray"})


def _type_of(param: inspect.Parameter) -> str:
    ann = param.annotation
    if ann is not inspect.Parameter.empty:
        if not isinstance(ann, str):
            ann = _TYPE_NAMES.get(ann, getattr(ann, "__name__", str(ann)))
        name = ann.split("|")[0].strip()
        return "array" if name in _ARRAY_TYPES else name
    if param.default is not inspect.Parameter.empty \
            and param.default is not None:
        return _TYPE_NAMES.get(type(param.default),
                               type(param.default).__name__)
    return "array"


def _doc_for(doc: str, pname: str) -> str:
    """First docstring line that mentions the parameter by name."""
    if not doc:
        return ""
    pat = re.compile(rf"\b{re.escape(pname)}\b")
    for line in doc.splitlines():
        line = line.strip()
        if pat.search(line) and not line.startswith(('"', ">>>")):
            return line[:140]
    return ""


def _primary_callable(info):
    """Resolve the block's primary callable the same way the pipeline
    executor does: factory() → function | (encode, ...) tuple → first
    element | object → first processing method."""
    try:
        obj = info.factory()
    except Exception:  # noqa: BLE001 — param-requiring factory
        return None, "factory"
    if callable(obj) and not isinstance(obj, type):
        return obj, "function"
    if isinstance(obj, type):
        return obj, "constructor"
    if isinstance(obj, (tuple, list)) and obj and callable(obj[0]):
        return obj[0], "pair"
    for meth in ("process", "step", "compute", "apply", "run",
                 "demodulate", "modulate", "push", "update"):
        m = getattr(obj, meth, None)
        if callable(m):
            return m, f"method:{meth}"
    return None, "object"


def build_schema(info) -> list[dict]:
    """Schema rows for one BlockInfo (see module docstring)."""
    fn, kind = _primary_callable(info)
    if fn is None:
        return []
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return []
    doc = inspect.getdoc(fn) or ""
    declared = set(info.params)
    rows = []
    for p in sig.parameters.values():
        if p.kind in (inspect.Parameter.VAR_POSITIONAL,
                      inspect.Parameter.VAR_KEYWORD):
            continue
        if p.name == "self":
            continue
        required = p.default is inspect.Parameter.empty
        role = ("input" if p.name in _INPUT_NAMES
                and p.name not in declared else "param")
        default = None if required else p.default
        if default is not None and not isinstance(
                default, (int, float, bool, str)):
            default = repr(default)
        rows.append({
            "name": p.name,
            "type": _type_of(p),
            "default": default,
            "required": required,
            "role": role,
            "doc": _doc_for(doc, p.name),
        })
    if kind != "function":
        for r in rows:
            r["via"] = kind
    return rows
