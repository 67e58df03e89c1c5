"""UDP IQ transport (udp_source_sink.rs).

PyTorch counterpart of ``r4w_tpu.net``. Wire format (header enabled,
udp_source_sink.rs:80-165):
  [seq u32 LE][interleaved f32 LE I/Q ...]
A tensor crosses to the host once, at the socket boundary: `host_iq` reads
it whole with one device-to-host copy, and the packets are cut from that
host array. Received samples are complex64 numpy arrays; the caller puts
them on its device.
"""

from __future__ import annotations

import dataclasses
import socket
import struct

import numpy as np
import torch


@dataclasses.dataclass
class UdpConfig:
    host: str = "0.0.0.0"
    port: int = 50000
    has_header: bool = True
    timeout_s: float = 1.0
    max_payload: int = 65000


def host_iq(samples) -> np.ndarray:
    """`samples` as a complex64 numpy array: a tensor by one read to the host."""
    if isinstance(samples, torch.Tensor):
        return samples.detach().to("cpu", torch.complex64).numpy()
    return np.asarray(samples, np.complex64)


def encode_packet(seq: int, samples, has_header: bool = True) -> bytes:
    """complex64 samples -> wire bytes."""
    x = host_iq(samples)
    inter = np.empty(x.size * 2, np.float32)
    inter[0::2] = x.real
    inter[1::2] = x.imag
    body = inter.tobytes()
    if has_header:
        return struct.pack("<I", seq & 0xFFFFFFFF) + body
    return body


def decode_packet(data: bytes, has_header: bool = True):
    """wire bytes -> (seq, complex64 samples)."""
    seq = 0
    if has_header:
        if len(data) < 4:
            return None
        seq = struct.unpack("<I", data[:4])[0]
        data = data[4:]
    if len(data) % 8 != 0:
        data = data[: len(data) - len(data) % 8]
    inter = np.frombuffer(data, np.float32)
    return seq, (inter[0::2] + 1j * inter[1::2]).astype(np.complex64)


class UdpSink:
    """Packetizing IQ sender (udp_source_sink.rs:174 UdpSink)."""

    def __init__(self, target_host: str, target_port: int, config: UdpConfig | None = None):
        self.config = config or UdpConfig()
        self.target = (target_host, target_port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.seq = 0
        self.packets_sent = 0
        self.samples_sent = 0

    def send(self, samples) -> int:
        """Send samples, split into MTU-sized packets; returns the number of
        packets."""
        x = host_iq(samples)
        max_iq = (self.config.max_payload - (4 if self.config.has_header else 0)) // 8
        n_packets = 0
        for start in range(0, len(x), max_iq):
            chunk = x[start : start + max_iq]
            self._sock.sendto(encode_packet(self.seq, chunk, self.config.has_header),
                              self.target)
            self.seq += 1
            n_packets += 1
            self.samples_sent += len(chunk)
        self.packets_sent += n_packets
        return n_packets

    def close(self):
        self._sock.close()


class UdpSource:
    """Receiving side with sequence-gap accounting (udp_source_sink.rs
    UdpSource / benchmark/receiver.rs:79)."""

    def __init__(self, config: UdpConfig | None = None):
        self.config = config or UdpConfig()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # a burst of MTU-sized IQ packets overflows the default ~208 KB
        # kernel buffer before the reader wakes; ask for 4 MB (kernel caps
        # apply) like the reference's benchmark receiver
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        except OSError:
            pass
        self._sock.bind((self.config.host, self.config.port))
        self._sock.settimeout(self.config.timeout_s)
        self.last_seq: int | None = None
        self.packets_received = 0
        self.packets_dropped = 0
        self.samples_received = 0

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def recv(self) -> np.ndarray | None:
        """One packet of samples, or None on timeout."""
        try:
            data, _ = self._sock.recvfrom(self.config.max_payload + 64)
        except socket.timeout:
            return None
        parsed = decode_packet(data, self.config.has_header)
        if parsed is None:
            return None
        seq, samples = parsed
        if self.config.has_header and self.last_seq is not None:
            gap = (seq - self.last_seq - 1) & 0xFFFFFFFF
            if 0 < gap < 1 << 16:
                self.packets_dropped += gap
        self.last_seq = seq
        self.packets_received += 1
        self.samples_received += len(samples)
        return samples

    def recv_batch(self, max_packets: int = 64) -> np.ndarray:
        """Drain up to max_packets into one array (recv_batch)."""
        parts = []
        for _ in range(max_packets):
            s = self.recv()
            if s is None:
                break
            parts.append(s)
        return np.concatenate(parts) if parts else np.zeros(0, np.complex64)

    def close(self):
        self._sock.close()
