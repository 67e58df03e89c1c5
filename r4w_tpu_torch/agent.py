"""Remote agent: TCP JSON control plane + UDP IQ data plane.

PyTorch counterpart of ``r4w_tpu.agent`` (agent/mod.rs; protocol.rs:11
AgentCommand, server.rs:57, client.rs:41): newline-delimited JSON commands
on TCP (default port 6000) — status/ping/start_tx/stop_tx/start_rx/
stop_rx/metrics/list_waveforms/shutdown — driving UDP IQ streams
(`net`). `start_tx` modulates on the agent's device (the card unless
named), reads the burst to the host once, and streams it from a thread.
"""

from __future__ import annotations

import json
import socket
import threading
import time

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, resolve_device
from r4w_tpu_torch.net import host_iq
from r4w_tpu_torch.observe.logging import get_logger

log = get_logger("agent")

DEFAULT_PORT = 6000


class AgentServer:
    """Single-threaded-per-connection JSON command server."""

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 device=DEFAULT_DEVICE):
        # Loopback by default: the JSON control plane is unauthenticated
        # and start_tx streams UDP to a caller-supplied target, so binding
        # all interfaces must be an explicit operator decision.
        self.device = resolve_device(device)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(4)
        self._running = False
        self._tx_thread: threading.Thread | None = None
        self._tx_stop = threading.Event()
        self._rx_source = None
        self.start_time = time.time()
        self.tx_sent = {"packets": 0, "samples": 0}  # by the latest start_tx so far

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    # -- command handlers ---------------------------------------------------
    def _handle(self, cmd: dict) -> dict:
        op = (cmd.get("command") or cmd.get("type") or "").lower()
        try:
            if op == "ping":
                return {"response": "pong", "timestamp": time.time()}
            if op == "status":
                return {"response": "status", "data": {
                    "uptime_s": time.time() - self.start_time,
                    "tx_active": bool(self._tx_thread and self._tx_thread.is_alive()),
                    "rx_active": self._rx_source is not None,
                }}
            if op == "list_waveforms":
                from r4w_tpu_torch.waveforms import list_waveforms

                return {"response": "ok", "data": list_waveforms()}
            if op == "start_tx":
                return self._start_tx(cmd)
            if op == "stop_tx":
                self._tx_stop.set()
                return {"response": "ok", "message": "tx stopped"}
            if op == "start_rx":
                from r4w_tpu_torch.net import UdpConfig, UdpSource

                self._rx_source = UdpSource(UdpConfig(host="127.0.0.1",
                                                      port=int(cmd.get("port", 50000)),
                                                      timeout_s=0.25))
                return {"response": "ok", "message": f"rx on :{self._rx_source.port}"}
            if op == "stop_rx":
                stats = {}
                if self._rx_source:
                    stats = {"packets": self._rx_source.packets_received,
                             "dropped": self._rx_source.packets_dropped,
                             "samples": self._rx_source.samples_received}
                    self._rx_source.close()
                    self._rx_source = None
                return {"response": "ok", "data": stats}
            if op == "metrics":
                from r4w_tpu_torch.observe import REGISTRY

                return {"response": "metrics", "data": REGISTRY.to_prometheus()}
            if op == "shutdown":
                self._running = False
                return {"response": "ok", "message": "shutting down"}
            return {"response": "error", "message": f"unknown command {op}"}
        except Exception as e:  # noqa: BLE001 - agent must answer
            return {"response": "error", "message": str(e)}

    def _start_tx(self, cmd: dict) -> dict:
        from r4w_tpu_torch.net import UdpSink
        from r4w_tpu_torch.waveforms import create_waveform

        target = cmd.get("target", "127.0.0.1:50000")
        host, port = target.rsplit(":", 1)
        wf = create_waveform(cmd.get("waveform", "BPSK"),
                             float(cmd.get("sample_rate", 125_000.0)), self.device)
        if wf is None:
            return {"response": "error", "message": "unknown waveform"}
        samples = host_iq(wf.modulate(cmd.get("message", "agent tx").encode()))
        repeat = bool(cmd.get("repeat", False))
        pps = float(cmd.get("pps", 0))
        self._tx_stop.clear()

        def tx_loop():
            sink = UdpSink(host, int(port))
            while not self._tx_stop.is_set():
                sink.send(samples)
                self.tx_sent = {"packets": sink.packets_sent, "samples": sink.samples_sent}
                if not repeat:
                    break
                if pps > 0:
                    time.sleep(1.0 / pps)
            sink.close()

        self._tx_thread = threading.Thread(target=tx_loop, daemon=True)
        self._tx_thread.start()
        return {"response": "ok", "message": f"tx {len(samples)} samples -> {target}"}

    def join_tx(self, timeout: float | None = None) -> bool:
        """Wait for the transmit thread to end; True if none is running."""
        if self._tx_thread is not None:
            self._tx_thread.join(timeout)
        return not (self._tx_thread and self._tx_thread.is_alive())

    # -- server loop ----------------------------------------------------------
    def serve_forever(self):
        self._running = True
        self._sock.settimeout(0.5)
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            with conn:
                f = conn.makefile("rw")
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        cmd = json.loads(line)
                    except json.JSONDecodeError:
                        resp = {"response": "error", "message": "invalid JSON"}
                    else:
                        resp = self._handle(cmd)
                    f.write(json.dumps(resp) + "\n")
                    f.flush()
                    if not self._running:
                        break
        self._tx_stop.set()
        self._sock.close()

    def serve_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


class AgentClient:
    """JSON command client (agent/client.rs:41)."""

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 timeout_s: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout_s)
        self._f = self._sock.makefile("rw")

    def call(self, command: str, **kwargs) -> dict:
        self._f.write(json.dumps({"command": command, **kwargs}) + "\n")
        self._f.flush()
        return json.loads(self._f.readline())

    def ping(self) -> dict:
        return self.call("ping")

    def status(self) -> dict:
        return self.call("status")

    def start_tx(self, target: str, waveform: str = "BPSK", message: str = "hello",
                 sample_rate: float = 125_000.0, repeat: bool = False, pps: float = 0) -> dict:
        return self.call("start_tx", target=target, waveform=waveform, message=message,
                         sample_rate=sample_rate, repeat=repeat, pps=pps)

    def stop_tx(self) -> dict:
        return self.call("stop_tx")

    def shutdown(self) -> dict:
        return self.call("shutdown")

    def close(self):
        self._sock.close()
