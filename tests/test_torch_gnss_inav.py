"""The port's I/NAV page coding against ``r4w_tpu.gnss.inav``, bit for bit.

Encoding runs the port's `conv_encode` on the host; decoding runs its soft
Viterbi decoder (the plain versions here, on CPU tensors). Soft symbols
are encoded pages plus numpy Gaussian noise (std 0.3-1.2 on ±1 symbols),
some with the polarity flipped; both packages get the same float64 input
and round it to float32 at the decoder. Tolerance 0: decoded bits, CRC
verdicts and page anchors are equal. `decode_stream` decodes every part
of a stream in one batched call; its pages equal the reference's, which
decodes page by page.
"""

import numpy as np
import pytest
import torch

from r4w_tpu.gnss import inav as ref_inav
from r4w_tpu_torch.core import types
from r4w_tpu_torch.gnss import inav
from r4w_tpu_torch.kernels import viterbi

NOISE_STDS = (0.3, 0.8, 1.2)


def _pages(rng, n):
    return [(rng.integers(0, 2, 112), rng.integers(0, 2, 16), int(rng.integers(0, 2 ** 40)),
             int(rng.integers(0, 2 ** 22)), int(rng.integers(0, 256))) for _ in range(n)]


def _stream(seed, n_pages, lead, std, polarity, skip=0):
    """±1 soft symbols: `lead` random symbols, then `n_pages` encoded pages
    less their first `skip` symbols, plus noise of `std`, times `polarity`."""
    rng = np.random.default_rng(seed)
    pages = [ref_inav.encode_page(*p) for p in _pages(rng, n_pages)]
    syms = np.concatenate([rng.integers(0, 2, lead), np.concatenate(pages)[skip:]])
    soft = 1.0 - 2.0 * syms.astype(np.float64)
    return polarity * (soft + std * rng.standard_normal(len(soft)))


def _equal_pages(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_page_equals_reference(seed):
    for args in _pages(np.random.default_rng(seed), 2):
        got, want = inav.encode_page(*args), ref_inav.encode_page(*args)
        assert got.dtype == want.dtype and got.shape == (500,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("std", NOISE_STDS)
def test_decode_part_bit_for_bit(std):
    soft = _stream(int(std * 10), 2, 0, std, 1.0)
    for start in (10, 260):  # the even and the odd part, sync stripped
        part = soft[start:start + 240]
        got = inav.decode_part(part, device="cpu")
        assert got.dtype == np.int32 and got.shape == (114,)
        np.testing.assert_array_equal(got, np.asarray(ref_inav.decode_part(part)))


@pytest.mark.parametrize("std", NOISE_STDS)
def test_decode_page_bit_for_bit(std):
    soft = _stream(7 + int(std * 10), 1, 0, std, 1.0)
    _equal_pages([inav.decode_page(soft, device="cpu")], [ref_inav.decode_page(soft)])


@pytest.mark.parametrize("polarity", [1.0, -1.0])
@pytest.mark.parametrize("lead,skip,std", [(137, 0, 0.3), (311, 0, 0.8), (40, 250, 0.3),
                                           (3, 0, 1.2)])
def test_decode_stream_page_for_page(lead, skip, std, polarity):
    """Offset grids, a random part's worth first (lead 311), the stream
    opening on an odd part (skip 250: the grid slips one part), noise up
    to CRC failures, either sign."""
    soft = _stream(lead, 3, lead, std, polarity, skip)
    got, want = inav.decode_stream(soft, device="cpu"), ref_inav.decode_stream(soft)
    _equal_pages(got, want)
    if std < 1.0:
        assert [p["crc_ok"] for p in got] == [True] * (3 if skip == 0 else 2)


def test_decode_stream_is_one_batched_decode(monkeypatch):
    """Every complete part of the stream is one lane of one decode call."""
    calls = []
    orig = inav.viterbi_decode

    def spy(received, *args, **kwargs):
        calls.append(tuple(received.shape))
        return orig(received, *args, **kwargs)

    monkeypatch.setattr(inav, "viterbi_decode", spy)
    soft = _stream(5, 4, 90, 0.3, -1.0)
    pages = inav.decode_stream(soft, device="cpu")
    assert len(pages) == 4 and calls == [((len(soft) - 90) // 250, 240)]
    assert inav.decode_stream(soft[:400], device="cpu") == [] and len(calls) == 1


def test_decode_defaults_to_the_card(monkeypatch):
    """With no device named the decoder's input goes to DEFAULT_DEVICE;
    on `meta` the Viterbi dispatch refuses it, so nothing ran on the CPU."""
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("meta"))
    soft = _stream(3, 1, 0, 0.3, 1.0)
    with pytest.raises(ValueError, match="meta"):
        inav.decode_part(soft[10:250])
    with pytest.raises(ValueError, match="meta"):
        inav.decode_stream(soft)


@pytest.mark.cuda
def test_decode_stream_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Viterbi kernels have no CPU or interpret mode")
    soft = _stream(11, 5, 123, 0.9, -1.0)
    before = (viterbi.viterbi_forward.launches, viterbi.viterbi_traceback.launches)
    got = inav.decode_stream(soft, device="cuda")
    assert (viterbi.viterbi_forward.launches, viterbi.viterbi_traceback.launches) == (
        before[0] + 1, before[1] + 1)
    _equal_pages(got, inav.decode_stream(soft, device="cpu"))
