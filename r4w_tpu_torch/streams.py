"""Stream/PDU plumbing (stream_tags.rs, tagged_stream_*.rs, pdu.rs,
pdu_filter.rs, pdu_router.rs, message_port.rs, stream_{mux,demux,
switch}.rs, head.rs, skiphead.rs, delay.rs, valve.rs, selector.rs,
vector_*.rs, wav_source_sink.rs, burst_tagger.rs, hier_block.rs
re-designs).

PyTorch counterpart of ``r4w_tpu.streams``: a stream is a tensor (numpy
and lists go to `DEFAULT_DEVICE`, a tensor keeps its device), a tag is
(offset, key, value) metadata beside it, a PDU is a tensor plus a
metadata dict, and wiring is function composition. `burst_tagger` finds
the edges on the device and reads their offsets in one copy; the mux and
demux cut and join slices of the tensors; WAV files go through numpy and
the standard library's ``wave``.
"""

from __future__ import annotations

import dataclasses
import wave
from collections import defaultdict
from typing import Any, Callable

import numpy as np
import torch

from r4w_tpu_torch.core.types import to_tensor


# ------------------------------------------------------------ tags/PDUs


@dataclasses.dataclass(frozen=True)
class StreamTag:
    """Metadata pinned to a sample offset (stream_tags.rs)."""

    offset: int
    key: str
    value: Any


@dataclasses.dataclass
class Pdu:
    """Protocol data unit: payload + metadata (pdu.rs)."""

    data: Any
    meta: dict = dataclasses.field(default_factory=dict)


def pdu_filter(pdus, key: str, value=None):
    """Keep PDUs whose meta has key (and equals value if given)
    (pdu_filter.rs)."""
    out = []
    for p in pdus:
        if key in p.meta and (value is None or p.meta[key] == value):
            out.append(p)
    return out


def pdu_route(pdus, key: str):
    """Group PDUs by a meta key (pdu_router.rs) -> {value: [pdus]}."""
    table: dict = defaultdict(list)
    for p in pdus:
        table[p.meta.get(key)].append(p)
    return dict(table)


def pdu_set(pdus, key: str, value):
    """Set a meta key on every PDU (pdu_set.rs)."""
    for p in pdus:
        p.meta[key] = value
    return pdus


def stream_to_pdus(x, boundaries, meta_key: str = "index"):
    """Cut a stream at tag boundaries -> PDUs (tagged_stream_to_pdu.rs).
    boundaries: sorted sample offsets starting each PDU; each PDU's data
    is a view of the stream."""
    x = to_tensor(x)
    bounds = list(boundaries) + [x.shape[-1]]
    return [Pdu(x[..., bounds[i]:bounds[i + 1]], {meta_key: i})
            for i in range(len(bounds) - 1)]


def pdus_to_stream(pdus):
    """Concatenate PDUs back into one stream + start tags
    (pdu_to_tagged_stream.rs)."""
    datas = [to_tensor(p.data) for p in pdus]
    tags = []
    off = 0
    for p, d in zip(pdus, datas):
        tags.append(StreamTag(off, "pdu_start", dict(p.meta)))
        off += d.shape[-1]
    return (torch.cat(datas, dim=-1) if datas else to_tensor(np.zeros(0)),
            tags)


def burst_tagger(x, mask, key: str = "burst"):
    """Tags at rising/falling edges of a boolean mask (burst_tagger.rs),
    sorted by offset, rising before falling at one offset as the
    reference's stable sort leaves them."""
    m = to_tensor(mask).to(torch.int8).reshape(-1)
    d = torch.diff(m)
    rise = torch.nonzero(d == 1).reshape(-1) + 1
    fall = torch.nonzero(d == -1).reshape(-1) + 1
    both = torch.cat((rise, fall, m[:1].to(torch.int64))).cpu().tolist()
    rise, fall = both[:rise.numel()], both[rise.numel():rise.numel() + fall.numel()]
    tags = [StreamTag(int(i), key, True) for i in rise]
    tags += [StreamTag(int(i), key, False) for i in fall]
    if m.numel() and both[-1]:
        tags.insert(0, StreamTag(0, key, True))
    return sorted(tags, key=lambda t: t.offset)


# -------------------------------------------------------- stream blocks


def head(x, n: int):
    """First n samples (head.rs)."""
    return to_tensor(x)[..., :n]


def skiphead(x, n: int):
    """Drop the first n samples (skiphead.rs)."""
    return to_tensor(x)[..., n:]


def delay(x, n: int):
    """Prepend n zeros (delay.rs)."""
    x = to_tensor(x)
    return torch.cat([x.new_zeros((*x.shape[:-1], n)), x], dim=-1)


def valve(x, open_: bool):
    """Pass or block the stream (valve.rs)."""
    x = to_tensor(x)
    return x if open_ else x[..., :0]


def selector(streams, index: int):
    """Choose one of several input streams (selector.rs)."""
    return streams[index]


def stream_mux(streams, lengths):
    """Interleave fixed-length chunks round-robin (stream_mux.rs).
    streams: list of equal-chunk-count arrays; lengths[i] = chunk size
    taken from stream i per round."""
    arrs = [to_tensor(s) for s in streams]
    chunks = []
    pos = [0] * len(arrs)
    total = sum(a.shape[-1] for a in arrs)
    out_len = 0
    while out_len < total:
        for i, a in enumerate(arrs):
            take = min(lengths[i], a.shape[-1] - pos[i])
            if take > 0:
                chunks.append(a[..., pos[i]:pos[i] + take])
                pos[i] += take
                out_len += take
        if all(p >= a.shape[-1] for p, a in zip(pos, arrs)):
            break
    return torch.cat(chunks, dim=-1)


def stream_demux(x, lengths):
    """Inverse of stream_mux for full rounds (stream_demux.rs)."""
    x = to_tensor(x)
    outs = [[] for _ in lengths]
    pos = 0
    n = x.shape[-1]
    while pos < n:
        for i, ln in enumerate(lengths):
            take = min(ln, n - pos)
            if take <= 0:
                break
            outs[i].append(x[..., pos:pos + take])
            pos += take
    return [torch.cat(o, dim=-1) if o else x[..., :0] for o in outs]


def stream_to_vectors(x, vlen: int):
    """(..., N) -> (..., N//vlen, vlen) (stream_to_vector.rs)."""
    x = to_tensor(x)
    n = (x.shape[-1] // vlen) * vlen
    return x[..., :n].reshape(*x.shape[:-1], -1, vlen)


def vectors_to_stream(v):
    """Inverse of stream_to_vectors (vector_to_stream.rs)."""
    v = to_tensor(v)
    return v.reshape(*v.shape[:-2], -1)


def vector_map(v, fn: Callable):
    """Apply fn to each vector (vector_map.rs)."""
    return torch.stack([fn(row) for row in to_tensor(v)])


# ---------------------------------------------------------- message bus


class MessageBus:
    """In-process pub/sub control plane (message_port.rs role)."""

    def __init__(self):
        self._subs: dict[str, list[Callable]] = defaultdict(list)
        self._log: list[tuple[str, Any]] = []

    def subscribe(self, port: str, handler: Callable):
        self._subs[port].append(handler)

    def publish(self, port: str, message):
        self._log.append((port, message))
        for h in self._subs.get(port, []):
            h(message)

    def history(self, port: str | None = None):
        if port is None:
            return list(self._log)
        return [m for p, m in self._log if p == port]


def message_strobe(bus: MessageBus, port: str, message, count: int):
    """Publish the same message `count` times (message_strobe.rs,
    virtual-time form: no wall-clock sleeps)."""
    for _ in range(count):
        bus.publish(port, message)


# ------------------------------------------------------------ WAV files


def write_wav(path: str, samples, sample_rate: int = 48000):
    """Real samples -> 16-bit PCM WAV (wav_source_sink.rs write); a tensor
    is read to the host in one copy."""
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    x = np.asarray(samples, np.float64).reshape(-1)
    peak = np.max(np.abs(x)) or 1.0
    pcm = np.clip(x / peak * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes(pcm.tobytes())


def read_wav(path: str, device=None):
    """WAV -> (float32 samples in [-1, 1] on `device` (default: the CUDA
    card), sample_rate)."""
    with wave.open(path, "rb") as f:
        rate = f.getframerate()
        nch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width != 2:
        raise ValueError("only 16-bit PCM WAV supported")
    pcm = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    if nch > 1:
        pcm = pcm.reshape(-1, nch).mean(axis=1)
    return to_tensor(pcm, device=device), rate


# ------------------------------------------------------------ hierarchy


def chain(*fns: Callable) -> Callable:
    """Compose stream blocks left-to-right (hier_block.rs role):
    chain(f, g)(x) == g(f(x))."""
    def run(x):
        for f in fns:
            x = f(x)
        return x

    return run
