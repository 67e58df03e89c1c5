"""Block-graph pipeline executor — the engine behind the pipeline wizard
and the CLI `pipeline` command.

PyTorch counterpart of ``r4w_tpu.pipeline`` (the reference GUI's
pipeline builder, crates/r4w-gui/src/views/pipeline_wizard.rs: drag-drop
block graphs with per-block simulate) over the 523-block registry: a
pipeline is a JSON-serializable DAG of nodes, each naming a registry block
(or one of the waveform pseudo-blocks) plus parameters; execution runs the
graph topologically, adapts each block's call signature by inspection,
and captures a per-node output summary (shape/power plus downsampled
time/spectrum/constellation previews) so a UI can show every stage.

Node spec (dict):
  {"id": "n1", "block": "awgn_channel", "params": {"snr_db": 10},
   "inputs": ["n0"]}

Pseudo-blocks (beyond the registry):
  waveform_tx   params: name (factory waveform), hex (payload)
  waveform_rx   params: name — demodulates, reports decoded bits

Outputs stay on the pipeline's device (the card unless named) between
nodes. Only each node's summary is read to the host: its power (a float64
mean on the device), shape, dtype and the preview's subsampled points and
4096-point spectrum (float64). A block's failure, on device tensors as on
any other, is that node's error. Unlike the reference, the summary's
floats are not rounded.

The key slot: a block whose function takes a PRNG key first (the
reference's rule, ``names[0] == "key"``) gets the `channel.threefry` key
``seed·7919 + i`` positionally, and a block that takes ``key`` as a
keyword (``awgn`` and the other channel blocks, whose reference functions
take it first) gets it as ``key=``, so the draws are the reference's.
A block with a ``device`` parameter gets the pipeline's device.
"""

from __future__ import annotations

import inspect
from typing import Any

import numpy as np
import torch

from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, resolve_device

KEY_SEED_STRIDE = 7919


class PipelineError(ValueError):
    pass


def _coerce(value: Any) -> Any:
    """JSON/UI params arrive as strings — coerce numerics, keep lists."""
    if isinstance(value, str):
        v = value.strip()
        try:
            return int(v)
        except ValueError:
            pass
        try:
            return float(v)
        except ValueError:
            pass
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        return value
    if isinstance(value, list):
        return [_coerce(v) for v in value]
    return value


def _topo_order(nodes: list[dict]) -> list[dict]:
    by_id = {n["id"]: n for n in nodes}
    if len(by_id) != len(nodes):
        raise PipelineError("duplicate node ids")
    state: dict[str, int] = {}
    order: list[dict] = []

    def visit(nid: str):
        st = state.get(nid, 0)
        if st == 1:
            raise PipelineError(f"cycle through node {nid!r}")
        if st == 2:
            return
        state[nid] = 1
        node = by_id.get(nid)
        if node is None:
            raise PipelineError(f"unknown input node {nid!r}")
        for dep in node.get("inputs", []):
            visit(dep)
        state[nid] = 2
        order.append(node)

    for n in nodes:
        visit(n["id"])
    return order


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def dtype_name(x: torch.Tensor) -> str:
    """A tensor's dtype as numpy names it (``complex64``, ``int32``, ...)."""
    return str(x.dtype).removeprefix("torch.")


def power_db(x: torch.Tensor) -> float:
    """10·log10(mean |x|²) in float64 on x's device."""
    p = torch.mean(torch.abs(x.to(torch.complex128)) ** 2)
    return float(10.0 * torch.log10(p + 1e-30))


def _preview(x: torch.Tensor, max_pts: int = 512) -> dict:
    """Downsampled plots-as-data for the browser: the points and the
    4096-point spectrum are cut on x's device and read as small arrays."""
    if x.ndim == 0:
        return {"kind": "scalar", "value": float(torch.real(x) if x.is_complex() else x)}
    flat = x.reshape(-1)
    is_complex = flat.is_complex()
    n = flat.shape[0]
    if n == 0:
        return {"kind": "empty"}
    step = max(1, n // max_pts)
    t = _host(flat[::step][:max_pts])
    out: dict[str, Any] = {"kind": "iq" if is_complex else "real", "n": int(n),
                           "time_re": np.real(t).astype(float).tolist()}
    if is_complex:
        out["time_im"] = np.imag(t).astype(float).tolist()
        # constellation scatter (subsampled)
        c = _host(flat[:: max(1, n // 500)][:500])
        out["const_re"] = np.real(c).astype(float).tolist()
        out["const_im"] = np.imag(c).astype(float).tolist()
    # power spectrum of the first nfft samples, 256 bins of its maxima
    nfft = min(4096, 1 << int(np.ceil(np.log2(max(n, 16)))))
    seg = flat[:nfft].to(torch.complex128 if is_complex else torch.float64)
    win = torch.from_numpy(np.hanning(seg.shape[0])).to(seg.device)
    spec = torch.fft.fftshift(torch.fft.fft(seg * win, nfft))
    psd = _host(20.0 * torch.log10(torch.abs(spec) + 1e-12))
    bins = np.array_split(psd, min(256, len(psd)))
    out["psd_db"] = [float(b.max()) for b in bins if b.size]
    return out


def key_slot(fn) -> str | None:
    """How a block's function takes the PRNG key: "positional" (its first
    parameter), "keyword" (a keyword-only ``key``) or None."""
    params = inspect.signature(fn).parameters
    names = list(params)
    if names and names[0] == "key":
        return "positional"
    if "key" in params and params["key"].kind == inspect.Parameter.KEYWORD_ONLY:
        return "keyword"
    return None


def _call_block(fn, inputs: list, params: dict, key, sample_rate: float = 48000.0,
                device=None):
    """Adapt a registry block's signature: the PRNG key in its slot,
    positional stream inputs, params matched to named arguments. A required
    `sample_rate`/`fs` argument not supplied by the node is filled from the
    pipeline-level default, a `device` argument from the pipeline's
    device."""
    sig = inspect.signature(fn)
    names = list(sig.parameters)
    args: list = []
    slot = key_slot(fn)
    if slot == "positional":
        args.append(key)
        names = names[1:]
    args.extend(inputs)
    has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                     for p in sig.parameters.values())
    kwargs = {k: _coerce(v) for k, v in params.items() if has_var_kw or k in names}
    if slot == "keyword" and "key" not in kwargs:
        kwargs["key"] = key
    consumed = names[: len(inputs)]
    for k in ("sample_rate", "fs"):
        p = sig.parameters.get(k)
        if (p is not None and k not in kwargs and k not in consumed
                and p.default is inspect.Parameter.empty
                and p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                               inspect.Parameter.KEYWORD_ONLY)):
            kwargs[k] = float(sample_rate)
    if "device" in sig.parameters and "device" not in kwargs and "device" not in consumed:
        kwargs["device"] = device
    return fn(*args, **kwargs)


def _waveform(params: dict, device):
    from r4w_tpu_torch.waveforms import create_waveform

    name = params.get("name", "BPSK")
    wf = create_waveform(str(name), float(_coerce(params.get("sample_rate", 48000.0))), device)
    if wf is None:
        raise PipelineError(f"unknown waveform {name!r}")
    return wf


def _run_waveform_tx(params: dict, device):
    wf = _waveform(params, device)
    payload = bytes.fromhex(str(params.get("hex", "A71B3CD2")))
    return wf.modulate(payload), {"samples_per_symbol": wf.samples_per_symbol()}


def _run_waveform_rx(x, params: dict, device):
    wf = _waveform(params, device)
    res = wf.demodulate(x)
    data = res.bits.to(torch.uint8)  # byte values per element
    host = _host(data)
    info = {"decoded_hex": bytes(host).hex()[:64], "snr_estimate_db": res.snr_estimate}
    want = params.get("hex")
    if want:
        ref = np.frombuffer(bytes.fromhex(str(want)), np.uint8)
        got = host[: len(ref)]
        info["decoded_ok"] = bool(len(got) == len(ref) and (got == ref).all())
    return data.to(torch.int32), info


def _as_tensor(out) -> torch.Tensor:
    """A block's output as a tensor: tensors as they are, host values
    (numpy arrays, numbers) as CPU tensors."""
    if isinstance(out, torch.Tensor):
        return out
    return torch.from_numpy(np.array(out))


def _scalar(part) -> float | None:
    """A one-element auxiliary output's value (the reference's
    ``np.asarray(part).size == 1``), else None."""
    if isinstance(part, torch.Tensor):
        return float(torch.real(part).reshape(-1)[0]) if part.numel() == 1 else None
    if isinstance(part, (tuple, list)):
        return _scalar(part[0]) if len(part) == 1 else None
    arr = np.asarray(part)
    return float(np.real(arr.item())) if arr.size == 1 and arr.dtype != object else None


def run_pipeline(nodes: list[dict], seed: int = 0, previews: bool = True,
                 sample_rate: float = 48000.0, device=DEFAULT_DEVICE) -> dict:
    """Execute a block graph on `device`. Returns {"nodes": {id:
    {summary...}}, "order": [...], "ok": bool}. Per-node failures are
    recorded, not raised; downstream nodes missing their input are
    skipped."""
    from r4w_tpu_torch.registry import default_registry

    dev = resolve_device(device)
    reg = default_registry()
    order = _topo_order(list(nodes))
    outputs: dict[str, Any] = {}
    report: dict[str, Any] = {}
    ok = True
    for i, node in enumerate(order):
        nid = node["id"]
        block = str(node.get("block", ""))
        params = dict(node.get("params", {}) or {})
        entry: dict[str, Any] = {"block": block}
        try:
            ins = []
            for dep in node.get("inputs", []):
                if dep not in outputs:
                    raise PipelineError(f"input {dep!r} unavailable")
                ins.append(outputs[dep])
            key = threefry.key(seed * KEY_SEED_STRIDE + i)
            extra: dict[str, Any] = {}
            if block == "waveform_tx":
                out, extra = _run_waveform_tx(params, dev)
            elif block == "waveform_rx":
                if not ins:
                    raise PipelineError("waveform_rx needs an input")
                out, extra = _run_waveform_rx(ins[0], params, dev)
            else:
                info = reg.get(block)
                if info is None:
                    raise PipelineError(f"unknown block {block!r}")
                fn = info.factory()
                result = _call_block(fn, ins, params, key, sample_rate=sample_rate, device=dev)
                out = result
                if isinstance(result, tuple):
                    out = result[0]
                    for j, part in enumerate(result[1:], 1):
                        value = _scalar(part)
                        if value is not None:
                            extra[f"aux{j}"] = value
            out_t = _as_tensor(out)
            outputs[nid] = out_t
            entry["shape"] = list(out_t.shape)
            entry["dtype"] = dtype_name(out_t)
            if out_t.numel():
                entry["power_db"] = power_db(out_t)
            entry.update(extra)
            if previews:
                entry["preview"] = _preview(out_t)
        except Exception as e:  # noqa: BLE001 — per-node reporting
            ok = False
            entry["error"] = f"{type(e).__name__}: {e}"[:200]
        report[nid] = entry
    return {"ok": ok, "order": [n["id"] for n in order], "nodes": report}
