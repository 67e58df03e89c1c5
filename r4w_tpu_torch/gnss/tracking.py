"""DLL/PLL tracking channels, one code block a step, batched over channels.

PyTorch counterpart of ``r4w_tpu.gnss.tracking`` (a re-design of
waveform/gnss/tracking.rs:36-446): per block, the early, prompt and late
correlations are one batched gather and sum over the block, and the loop
state (code phase, carrier frequency and phase, filter integrators) is
carried from block to block by a Python loop in place of ``lax.scan``.
Every state field and output has a leading channel axis, the counterpart
of ``jax.vmap(track)``: C channels advance together, one small launch per
operation for all of them. The loop never reads a tensor on the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor

GPS_L1_HZ = 1_575_420_000.0


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    code_length: int = 1023
    sample_rate: float = 1_023_000.0
    chipping_rate: float = 1_023_000.0
    dll_bandwidth: float = 1.0
    pll_bandwidth: float = 15.0
    el_spacing: float = 0.5  # chips
    block_period: float = 0.001  # seconds per update (1 ms)
    carrier_hz: float = GPS_L1_HZ
    # Costas (decision-insensitive) phase discriminator atan(Q/I) in place
    # of atan2(Q, I): required whenever the prompt sign can flip per block
    # (GPS nav bits, the Galileo E1C secondary code). False only for a
    # pilot channel whose overlay has been wiped.
    costas: bool = True
    # FLL (cross-product) frequency-assist gain: pulls in the acquisition
    # Doppler quantization fast; noisy at low C/N0, so 0.0 for a narrow
    # stage once the frequency is pulled in.
    fll_gain: float = 0.3

    @property
    def block_size(self) -> int:
        return int(round(self.sample_rate * self.block_period))

    def loop_gains(self):
        """(dll k1 k2, pll k1 k2 k3) per tracking.rs:364-433."""
        t = self.block_period
        wn_d = self.dll_bandwidth * 8.0 / 3.0
        zeta = 1.0 / np.sqrt(2.0)
        dll = (2 * zeta * wn_d * t, (wn_d * t) ** 2)
        wn_p = self.pll_bandwidth * 2.4
        pll = (2.4 * wn_p * t, 1.1 * (wn_p * t) ** 2, (wn_p * t) ** 3)
        return dll, pll


class TrackingState(NamedTuple):
    code_phase: torch.Tensor  # chips
    code_freq: torch.Tensor  # chips/s
    carrier_phase: torch.Tensor  # cycles
    carrier_freq: torch.Tensor  # Hz
    dll_int: torch.Tensor
    pll_int1: torch.Tensor
    pll_int2: torch.Tensor
    prev_prompt: torch.Tensor  # complex, for the FLL cross-product


class TrackingOutput(NamedTuple):
    prompt_i: torch.Tensor  # (C, B) per block, or (B,) for one channel
    prompt_q: torch.Tensor
    early_mag: torch.Tensor
    late_mag: torch.Tensor
    dll_disc: torch.Tensor
    pll_disc: torch.Tensor
    carrier_freq: torch.Tensor
    code_phase: torch.Tensor
    cn0_dbhz: torch.Tensor
    # auxiliary data-channel prompts slaved to the same NCO (e.g. Galileo
    # E1B symbols off the E1C pilot loop): (C, B, aux_per_block) complex
    # sub-prompts as real and imaginary parts; zeros without an aux_code
    aux_i: torch.Tensor
    aux_q: torch.Tensor


# the per-block real outputs, in TrackingOutput's order
_BLOCK_FIELDS = TrackingOutput._fields[:9]


def init_state(cfg: TrackingConfig, code_phase_chips, doppler_hz, device=None
               ) -> TrackingState:
    """Loop state at a code phase (chips) and Doppler (Hz), each a scalar
    or one entry per channel. Tensors keep their device; numbers and numpy
    go to `device` (default: the CUDA card)."""
    code_phase = to_tensor(code_phase_chips, REAL_DTYPE, device)
    doppler = to_tensor(doppler_hz, REAL_DTYPE, device).to(code_phase.device)
    code_doppler = doppler * (cfg.chipping_rate / cfg.carrier_hz)
    z = torch.zeros_like(code_phase)
    return TrackingState(
        code_phase=code_phase,
        code_freq=cfg.chipping_rate + code_doppler,
        carrier_phase=z,
        carrier_freq=doppler,
        dll_int=z, pll_int1=z, pll_int2=z,
        prev_prompt=torch.zeros_like(z, dtype=IQ_DTYPE),
    )


def track(cfg: TrackingConfig, state: TrackingState, samples, code,
          aux_code=None, aux_per_block: int = 1, start=None, wipe=None
          ) -> tuple[TrackingState, TrackingOutput]:
    """Run the tracking loop over whole blocks of `samples`.

    state: a `TrackingState` whose fields are scalars (one channel) or
    (C,) tensors (C channels). code: (code_length,) ±1 chips shared by
    every channel, or (C, code_length). samples: (N,) complex64 shared by
    every channel, or (C, N) one row a channel, tracked from sample 0 over
    N // block_size blocks. With `start` ((C,) sample offsets into an (N,)
    capture), channel c's block m is samples[start[c] + m·bs : ... + bs],
    read by index per block (the capture is not copied per channel), over
    (N - max(start)) // bs blocks.

    aux_code: optional second spreading code, (code_length,) or (C,
    code_length), correlated open-loop at the prompt's chip and carrier
    alignment (the data-channel companion of a pilot loop); each block
    yields `aux_per_block` sub-prompts over equal sample spans.

    wipe: optional (C, B', k) signs (or any real weights): block m of
    channel c is split into k equal spans and span j multiplied by
    wipe[c, m, j] before the loop reads it (the E1C pilot pass's input
    wipe of the secondary code, one sign a 4 ms epoch), as if the capture
    had been multiplied first; B' ≥ the blocks tracked.

    Returns the final state and the per-block outputs, (C, B) each (aux
    (C, B, aux_per_block)), or (B,) and (B, aux_per_block) when the state,
    the samples and the codes all have no channel axis.
    """
    bs = cfg.block_size
    if bs % aux_per_block:
        raise ValueError(f"block size {bs} is not a multiple of aux_per_block {aux_per_block}")
    device = state.code_phase.device
    samples = to_tensor(samples, IQ_DTYPE, device)
    code = to_tensor(code, REAL_DTYPE, device)
    aux = None if aux_code is None else to_tensor(aux_code, REAL_DTYPE, device)
    single = (state.code_phase.dim() == 0 and code.dim() == 1
              and (samples.dim() == 1 or start is not None)
              and (aux is None or aux.dim() == 1))
    n_ch = max(state.code_phase.numel(), code.shape[0] if code.dim() == 2 else 1,
               samples.shape[0] if samples.dim() == 2 else 1,
               len(start) if start is not None else 1,
               aux.shape[0] if aux is not None and aux.dim() == 2 else 1)
    st = TrackingState(*(f.reshape(-1).expand(n_ch).clone() for f in state))
    code = code.reshape(-1, code.shape[-1]).expand(n_ch, -1)
    if aux is not None:
        aux = aux.reshape(-1, aux.shape[-1]).expand(n_ch, -1)
    i_idx = torch.arange(bs, dtype=REAL_DTYPE, device=device)
    if start is not None:
        if samples.dim() != 1:
            raise ValueError("start indexes one shared (N,) capture")
        start = torch.as_tensor(np.asarray(start, np.int64), device=device)
        n_blocks = (samples.shape[-1] - int(start.max())) // bs
        window = start[:, None] + torch.arange(bs, device=device)  # (C, bs)
        blocks = None
    else:
        n_blocks = samples.shape[-1] // bs
        blocks = samples[..., : n_blocks * bs].reshape(-1, n_blocks, bs).expand(n_ch, -1, -1)
    if wipe is not None:
        wipe = to_tensor(wipe, REAL_DTYPE, device)
        if wipe.shape[1] < n_blocks or bs % wipe.shape[2]:
            raise ValueError(f"wipe {tuple(wipe.shape)} does not cover {n_blocks} blocks of {bs}")
        wipe = wipe.expand(n_ch, -1, -1)
    record = torch.empty((n_blocks, n_ch, len(_BLOCK_FIELDS)), dtype=REAL_DTYPE, device=device)
    aux_record = torch.zeros((n_blocks, n_ch, aux_per_block), dtype=IQ_DTYPE, device=device)
    step = _Step(cfg, code, aux, aux_per_block, i_idx)
    for m in range(n_blocks):
        block = blocks[:, m] if blocks is not None else samples[window + m * bs]
        if wipe is not None:
            k = wipe.shape[2]
            block = (block.reshape(n_ch, k, bs // k) * wipe[:, m, :, None]).reshape(n_ch, bs)
        st = step(st, block, record[m], aux_record[m])
    outs = {name: record[..., j].T.contiguous() for j, name in enumerate(_BLOCK_FIELDS)}
    aux_out = aux_record.permute(1, 0, 2)
    outs["aux_i"], outs["aux_q"] = aux_out.real.contiguous(), aux_out.imag.contiguous()
    if single:
        st = TrackingState(*(f[0] for f in st))
        outs = {name: v[0] for name, v in outs.items()}
    return st, TrackingOutput(**outs)


class _Step:
    """One block of every channel: the body of the JAX package's scan,
    with the same float32 expressions in the same order."""

    def __init__(self, cfg: TrackingConfig, code: torch.Tensor, aux: torch.Tensor | None,
                 aux_per_block: int, i_idx: torch.Tensor):
        self.cfg = cfg
        self.code = code[:, None, :]  # (C, 1, L): gathered along the last axis
        self.aux = aux
        self.aux_per_block = aux_per_block
        self.i_idx = i_idx
        # constants as device scalars (real_scalar), so that each quotient is
        # the reference's: a chip position one ulp off moves the code phase
        const = functools.partial(real_scalar, device=i_idx.device)
        self.sample_rate = const(cfg.sample_rate)
        self.block_size = const(float(i_idx.numel()))
        self.two_pi = const(2.0 * math.pi)
        self.fll_scale = const(2.0 * 2.0 * math.pi * cfg.block_period)
        self.code_per_carrier = const(cfg.chipping_rate / cfg.carrier_hz)
        self.block_period = const(cfg.block_period)
        self.inv_sample_rate = torch.reciprocal(self.sample_rate)
        self.t_in_block = i_idx / self.sample_rate
        half = cfg.el_spacing / 2.0
        # early, prompt, late: chip + offset with the scan's float32 offsets
        self.offsets = torch.tensor([-half, 0.0, half], dtype=REAL_DTYPE,
                                    device=i_idx.device)[None, :, None]
        (dk1, dk2), (pk1, pk2, pk3) = cfg.loop_gains()
        self.dk1, self.dk2, self.pk1 = float(dk1), float(dk2), float(pk1)
        t_blk = cfg.block_period
        self.pk2_t = float(pk2 / t_blk)
        self.pk3_tt = float(pk3 / (t_blk * t_blk))

    def __call__(self, st: TrackingState, block: torch.Tensor, record: torch.Tensor,
                 aux_record: torch.Tensor) -> TrackingState:
        cfg, length = self.cfg, self.cfg.code_length
        bs = block.shape[-1]
        t_blk = cfg.block_period
        spc = self.sample_rate / st.code_freq  # samples per chip, (C,)
        # carrier strip (tracking.rs:186-194)
        ph = st.carrier_freq[:, None] * self.t_in_block + st.carrier_phase[:, None]
        stripped = block * cis((-2 * math.pi) * ph)
        # E/P/L replicas by linearly interpolated gathers
        chip = st.code_phase[:, None] + self.i_idx / spc[:, None]
        pos = torch.remainder(chip[:, None, :] + self.offsets, length)  # (C, 3, bs)
        i0f = torch.floor(pos)
        w = pos - i0f
        # a position a hair below 0 wraps to exactly L in float32; the
        # reference's gather clamps that index to L-1, so the replica there
        # is code[L-1] (w = 0). torch's gathers do not clamp: clamp here.
        i0 = i0f.to(torch.int64)
        i1 = i0 + 1
        i1 = i1.masked_fill(i1 >= length, 0)
        i0 = i0.clamp(max=length - 1)
        c = (torch.take_along_dim(self.code, i0, dim=-1) * (1.0 - w)
             + torch.take_along_dim(self.code, i1, dim=-1) * w)
        v = torch.sum(stripped[:, None, :] * c, dim=-1)  # (C, 3) complex
        prompt = v[:, 1]
        if self.aux is not None:
            # the prompt's alignment: mod(chip, L) is its position, offset 0
            a0, a1, wa = i0[:, 1], i1[:, 1], w[:, 1]
            ca = self.aux.gather(1, a0) * (1.0 - wa) + self.aux.gather(1, a1) * wa
            aux_record.copy_((stripped * ca).reshape(-1, self.aux_per_block,
                                                     bs // self.aux_per_block).sum(-1))
        mags = torch.abs(v)
        e_mag, l_mag = mags[:, 0], mags[:, 2]
        e_plus_l = e_mag + l_mag
        dll_disc = torch.where(e_plus_l > 0,
                               (e_mag - l_mag) / torch.clamp(e_plus_l, min=1e-12), 0.0)
        if cfg.costas:
            pll_disc = torch.atan2(prompt.imag * torch.sign(prompt.real),
                                   torch.abs(prompt.real)) / self.two_pi
        else:
            pll_disc = torch.atan2(prompt.imag, prompt.real) / self.two_pi
        # FLL cross-product, squared to remove data-bit flips
        cross = prompt * torch.conj(st.prev_prompt)
        cross = cross * cross
        freq_err_hz = torch.where(
            torch.abs(st.prev_prompt) > 0,
            torch.atan2(cross.imag, cross.real) / self.fll_scale, 0.0)
        # 2nd-order DLL; 3rd-order PLL as a phase-stepping NCO (pk1 steps
        # the phase, pk2 and pk3 trim frequency and its rate) plus the FLL
        dll_int = st.dll_int + self.dk2 * dll_disc
        code_corr = self.dk1 * dll_disc + dll_int
        pll_acc = st.pll_int2 + self.pk3_tt * pll_disc
        new_carrier_freq = (st.carrier_freq + self.pk2_t * pll_disc + pll_acc * t_blk
                            + cfg.fll_gain * freq_err_hz)
        # bs / spc as the reference's compiled scan evaluates it: XLA rewrites
        # bs / (fs / f) into (bs·f)·(1/fs); dividing differs by an ulp of ~L
        # chips in some blocks, always the same way, a drift the DLL takes
        # seconds to absorb
        chips_per_block = (self.block_size * st.code_freq) * self.inv_sample_rate
        # disc > 0 means the replica runs ahead of the signal: retard the code
        new_code_phase = torch.remainder(
            st.code_phase + chips_per_block - code_corr * cfg.el_spacing, length)
        new_carrier_phase = torch.remainder(
            st.carrier_phase + st.carrier_freq * t_blk + self.pk1 * pll_disc, 1.0)
        # the reference's compiled scan folds chipping_rate / carrier_hz into
        # one float32 constant, as init_state does
        code_doppler = new_carrier_freq * self.code_per_carrier
        p_pow = prompt.real ** 2 + prompt.imag ** 2
        noise = torch.clamp(torch.sum(torch.abs(stripped) ** 2, dim=-1) - p_pow / self.block_size,
                            min=1e-12)
        cn0 = 10.0 * torch.log10(torch.clamp(p_pow / noise / self.block_period, min=1e-12))
        record.copy_(torch.stack((prompt.real, prompt.imag, e_mag, l_mag, dll_disc, pll_disc,
                                  new_carrier_freq, new_code_phase, cn0), dim=-1))
        return TrackingState(
            code_phase=new_code_phase,
            code_freq=cfg.chipping_rate + code_doppler,
            carrier_phase=new_carrier_phase,
            carrier_freq=new_carrier_freq,
            dll_int=dll_int, pll_int1=st.pll_int1, pll_int2=pll_acc,
            prev_prompt=prompt,
        )


def extract_nav_bits(prompt_i, bits_per_symbol: int = 20) -> torch.Tensor:
    """Majority-vote nav bits from prompt-I blocks (20 ms GPS bits;
    tracking.rs nav-bit extraction), over the last axis."""
    p = to_tensor(prompt_i)
    n = p.shape[-1] // bits_per_symbol
    groups = p[..., : n * bits_per_symbol].reshape(*p.shape[:-1], n, bits_per_symbol)
    return (torch.sum(torch.sign(groups), dim=-1) < 0).to(torch.int32)


def dll_s_curve(cfg: TrackingConfig, code, offsets_chips, device=None) -> torch.Tensor:
    """Open-loop DLL S-curve for test/visualization (tracking.rs:468-495):
    discriminator response vs true code offset, one entry per offset."""
    code = to_tensor(code, REAL_DTYPE, device)
    offsets = to_tensor(offsets_chips, REAL_DTYPE, code.device).reshape(-1, 1)
    bs = cfg.block_size
    spc = cfg.sample_rate / cfg.chipping_rate
    i_idx = torch.arange(bs, dtype=REAL_DTYPE, device=code.device)
    chip_true = i_idx / spc
    last = cfg.code_length - 1  # the reference's gathers clamp a wrap to exactly L
    sig = code[torch.remainder(chip_true, cfg.code_length).to(torch.int64).clamp(max=last)]
    chip_local = offsets + i_idx / spc
    half = cfg.el_spacing / 2.0

    def mag(o):
        idx = torch.remainder(chip_local + o, cfg.code_length).to(torch.int64).clamp(max=last)
        return torch.abs(torch.sum(sig * code[idx], dim=-1))

    e, l = mag(-half), mag(half)
    return (e - l) / torch.clamp(e + l, min=1e-12)
