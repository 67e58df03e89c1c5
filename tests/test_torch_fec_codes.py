"""The port's FEC codecs against ``r4w_tpu.fec`` on the same numpy inputs.

Interleavers, LDPC, DVB-S2X LDPC, turbo, the convolutional max-log-MAP,
polar, TCM and the fountain codes. Hard decisions must equal the
reference's; the turbo, MAP and TCM recursions are float32 adds, maxes
and mins in the reference's order, and are held to it exactly (tolerance
0). The min-sum beliefs sum each variable's messages in the layout's edge
order, which XLA's compiled scatter-add does not keep, so they agree
within `BELIEF_TOL`. The numpy parts the port copies (the LDPC
construction, DVB-S2X's parity structure, the RSC tables, the polar SC
decoder, the LT generator and decoder) are diffed against the
reference's source. TCM's decode runs the port's Viterbi dispatchers,
the plain versions here; ``cuda``-marked tests run the Hopper kernels.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.fec import convolutional as ref_conv
from r4w_tpu.fec import dvb_s2x as ref_dvb
from r4w_tpu.fec import fountain as ref_fountain
from r4w_tpu.fec import interleave as ref_il
from r4w_tpu.fec import ldpc as ref_ldpc
from r4w_tpu.fec import polar as ref_polar
from r4w_tpu.fec import tcm as ref_tcm
from r4w_tpu.fec import turbo as ref_turbo
from r4w_tpu_torch import convert
from r4w_tpu_torch.fec import convolutional, dvb_s2x, fountain, interleave, ldpc, polar, tcm, turbo
from r4w_tpu_torch.kernels import viterbi as viterbi_kernels

REPO = Path(__file__).resolve().parents[1]
# max|port - reference| / max|reference| of min-sum beliefs: float32 sums of a
# variable's 3-6 messages in another order (measured 1.3e-7)
BELIEF_TOL = 1e-6


def _segments(path: Path) -> dict[str, str]:
    """Source of each top-level function and assignment, by name."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.Assign):
            out[node.targets[0].id] = ast.get_source_segment(text, node)
    return out


@pytest.mark.parametrize("module,names", [
    ("ldpc", ("make_regular_ldpc",)),
    ("dvb_s2x", ("CODE_RATES", "FRAME_BITS", "_INFO_COL_WEIGHT", "_RATE_SEED", "_SIZE_SEED",
                 "_LCG_MUL", "_LCG_ADD", "info_bits", "parity_structure")),
    ("turbo", ("_K", "_S", "_rsc_tables", "rsc_encode", "default_interleaver")),
    ("polar", ("frozen_mask", "_f", "_g", "_sc_decode", "_reencode")),
    ("tcm", ("_K", "_POLYS", "_N_STATES", "_SUBSET_MAP", "_trellis")),
    ("fountain", ("robust_soliton", "lt_generator", "lt_decode")),
    ("interleave", ("conv_interleave_indices",)),
])
def test_numpy_parts_are_the_references_source(module, names):
    got = _segments(REPO / "r4w_tpu_torch" / "fec" / f"{module}.py")
    want = _segments(REPO / "r4w_tpu" / "fec" / f"{module}.py")
    for name in names:
        assert got[name] == want[name], name


def _noisy_llr(c: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(1 / (2 * 10 ** (snr_db / 10)))
    return (2 * ((1 - 2.0 * c) + rng.normal(0, sigma, c.shape)) / sigma ** 2).astype(np.float32)


# ---------------------------------------------------------------- interleavers


@pytest.mark.parametrize("shape,rows,cols", [((24,), 4, 6), ((3, 50), 4, 6), ((2, 5, 36), 6, 6)])
def test_block_interleave_matches_reference(shape, rows, cols):
    x = np.arange(np.prod(shape)).reshape(shape).astype(np.int32)
    y = interleave.block_interleave(torch.from_numpy(x), rows, cols)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref_il.block_interleave(x, rows, cols)))
    np.testing.assert_array_equal(
        interleave.block_deinterleave(y, rows, cols).numpy(),
        np.asarray(ref_il.block_deinterleave(np.asarray(y.numpy()), rows, cols)))


@pytest.mark.parametrize("pattern", [[3, 1, 4, 0, 2], [1, 0], [0, 2, 1, 5, 4, 3]])
def test_patterned_interleave_matches_reference(pattern):
    x = np.random.default_rng(0).standard_normal((3, 33)).astype(np.float32)
    y = interleave.patterned_interleave(torch.from_numpy(x), pattern)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref_il.patterned_interleave(x, pattern)))
    z = interleave.patterned_deinterleave(y, pattern)
    np.testing.assert_array_equal(z.numpy(), np.asarray(ref_il.patterned_deinterleave(
        y.numpy(), pattern)))
    n = 33 // len(pattern) * len(pattern)
    np.testing.assert_array_equal(z.numpy(), x[:, :n])


def test_conv_interleave_indices_match_reference():
    for n, b, d in ((48, 4, 2), (100, 3, 5), (17, 1, 0)):
        np.testing.assert_array_equal(interleave.conv_interleave_indices(n, b, d),
                                      ref_il.conv_interleave_indices(n, b, d))


# ---------------------------------------------------------------- LDPC


def test_ldpc_construction_equals_reference():
    for args in ((96, 3, 6), (48, 3, 6), (120, 3, 6)):
        for got, want in zip(ldpc.make_regular_ldpc(*args), ref_ldpc.make_regular_ldpc(*args)):
            np.testing.assert_array_equal(got, want)


def _jax_min_sum_beliefs(llr, edge_col, mask, iters, alpha=0.8):
    """The reference decoders' iteration (``r4w_tpu/fec/dvb_s2x.py:158-182``,
    which equals ``ldpc.py``'s where every slot is an edge) run in JAX,
    returning the beliefs the reference thresholds."""
    edge_col, mask = jnp.asarray(edge_col), jnp.asarray(mask)
    llr = jnp.asarray(llr, jnp.float32)
    batch = llr.shape[:-1]
    flat_cols = edge_col.reshape(-1)

    def var_sums(msg):
        return jnp.zeros_like(llr).at[..., flat_cols].add(
            jnp.where(mask, msg, 0.0).reshape(*batch, -1))

    def iteration(_, msg):
        belief = llr + var_sums(msg)
        v2c = belief[..., edge_col] - msg
        sign = jnp.where(mask, jnp.where(v2c < 0, -1.0, 1.0), 1.0)
        prod_sign = jnp.prod(sign, axis=-1, keepdims=True) * sign
        mag = jnp.where(mask, jnp.abs(v2c), jnp.inf)
        m1 = jnp.min(mag, axis=-1, keepdims=True)
        m2 = jnp.min(jnp.where(mag == m1, jnp.inf, mag), axis=-1, keepdims=True)
        n_min = jnp.sum(mag == m1, axis=-1, keepdims=True)
        m2 = jnp.where(n_min > 1, m1, m2)
        new = alpha * prod_sign * jnp.where((mag == m1) & (n_min == 1), m2, m1)
        new = jnp.where(jnp.isfinite(new), new, 0.0)
        return jnp.where(mask, new, 0.0)

    msg = jax.lax.fori_loop(0, iters, iteration, jnp.zeros(batch + edge_col.shape, jnp.float32))
    return np.asarray(llr + var_sums(msg))


@pytest.mark.parametrize("snr_db,seed", [(2.0, 6), (0.0, 1), (-1.0, 2)])
def test_ldpc_encode_decode_extract_match_reference(snr_db, seed):
    hg = ref_ldpc.make_regular_ldpc(96, 3, 6)
    u = np.random.default_rng(seed).integers(0, 2, (5, hg[2]))
    c = np.asarray(ref_ldpc.ldpc_encode(jnp.asarray(u), hg))
    np.testing.assert_array_equal(ldpc.ldpc_encode(torch.from_numpy(u), hg).numpy(), c)
    llr = _noisy_llr(c, snr_db, seed)
    code = convert.ldpc_code_from_reference(hg, "cpu")
    for iters in (1, 3, 25):
        hard, ok = ref_ldpc.ldpc_decode(jnp.asarray(llr), hg, iters=iters)
        got, got_ok = ldpc.ldpc_decode(torch.from_numpy(llr), code, iters=iters)
        np.testing.assert_array_equal(got.numpy(), np.asarray(hard))
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(ldpc.ldpc_extract_data(got, code).numpy(),
                                  np.asarray(ref_ldpc.ldpc_extract_data(hard, hg)))


def test_ldpc_beliefs_equal_the_references_iteration():
    hg = ref_ldpc.make_regular_ldpc(96, 3, 6)
    c = np.asarray(ref_ldpc.ldpc_encode(jnp.asarray(
        np.random.default_rng(3).integers(0, 2, (6, hg[2]))), hg))
    llr = _noisy_llr(c, 0.5, 3)
    code = ldpc.ldpc_code(hg, "cpu")
    edge_col, mask = code.layout.edge_col.numpy(), code.layout.edge_mask.numpy()
    for iters in (0, 2, 10):
        want = _jax_min_sum_beliefs(llr, edge_col, mask, iters)
        got = ldpc.min_sum(torch.from_numpy(llr), code.layout, iters, 0.8).numpy()
        assert np.max(np.abs(got - want)) <= BELIEF_TOL * np.max(np.abs(want))
    hard, _ = ref_ldpc.ldpc_decode(jnp.asarray(llr), hg, iters=10)
    np.testing.assert_array_equal((want < 0).astype(np.int32), np.asarray(hard))


def test_variable_table_lists_each_variables_edges_in_layout_order():
    st = dvb_s2x.parity_structure("3/4", "short")
    layout = ldpc.tanner(st["edge_col"], st["edge_mask"], st["n"], "cpu")
    table, flat_mask = layout.var_edges.numpy(), st["edge_mask"].reshape(-1)
    flat_cols = st["edge_col"].reshape(-1)
    for v in (0, 1, st["k"] - 1, st["k"], st["n"] - 1):
        real = [e for e in table[v] if flat_mask[e]]
        assert real == sorted(real) and all(flat_cols[e] == v for e in real)
        assert len(real) == int(((flat_cols == v) & flat_mask).sum())
        assert not flat_mask[table[v][len(real):]].any()  # padding points at empty slots


# ---------------------------------------------------------------- DVB-S2X


@pytest.mark.parametrize("rate,frame", [("1/2", "short"), ("9/10", "short"), ("1/4", "normal")])
def test_dvb_s2x_structure_equals_reference(rate, frame):
    got, want = dvb_s2x.parity_structure(rate, frame), ref_dvb.parity_structure(rate, frame)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
    st = convert.dvb_s2x_structure_from_reference(want, "cpu")
    assert (st.k, st.n, st.m) == (want["k"], want["n"], want["m"])
    np.testing.assert_array_equal(st.layout.edge_col.numpy(), want["edge_col"])


@pytest.mark.parametrize("rate", ["1/4", "1/2", "2/3", "9/10"])
def test_dvb_s2x_encode_matches_reference(rate):
    k = ref_dvb.info_bits(rate, "short")
    u = np.random.default_rng(len(rate)).integers(0, 2, (2, k)).astype(np.int32)
    got = dvb_s2x.encode(torch.from_numpy(u), rate, "short")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_dvb.encode(u, rate, "short")))


def test_dvb_s2x_decode_matches_reference_decisions_and_beliefs():
    rate, ebn0 = "1/2", 2.2  # near the threshold: decisions still move between iterations
    st = ref_dvb.parity_structure(rate, "short")
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, (2, st["k"])).astype(np.int32)
    c = np.asarray(ref_dvb.encode(u, rate, "short"))
    esn0 = 10 ** (ebn0 / 10) * 0.5
    llr = (4 * esn0 * ((1 - 2 * c) + rng.normal(0, np.sqrt(1 / (2 * esn0)), c.shape))
           ).astype(np.float32)
    for iters in (3, 12):
        hard, ok = ref_dvb.decode(jnp.asarray(llr), rate, "short", iters=iters)
        got, got_ok = dvb_s2x.decode(torch.from_numpy(llr), rate, "short", iters=iters)
        np.testing.assert_array_equal(got.numpy(), np.asarray(hard))
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ok))
    layout = dvb_s2x.device_structure(rate, "short", torch.device("cpu")).layout
    want = _jax_min_sum_beliefs(llr, st["edge_col"], st["edge_mask"], 12)
    got = ldpc.min_sum(torch.from_numpy(llr), layout, 12, 0.8).numpy()
    assert np.max(np.abs(got - want)) <= BELIEF_TOL * np.max(np.abs(want))


def test_dvb_s2x_rejects_wrong_lengths():
    with pytest.raises(ValueError, match="k = 8100"):
        dvb_s2x.encode(torch.zeros(100, dtype=torch.int32), "1/2", "short")
    with pytest.raises(ValueError, match="n = 16200"):
        dvb_s2x.decode(torch.zeros(100), "1/2", "short")


# ---------------------------------------------------------------- turbo


@pytest.mark.parametrize("n", [5, 40, 128, 1000])
def test_turbo_encode_matches_reference(n):
    bits = np.random.default_rng(n).integers(0, 2, n)
    want = ref_turbo.turbo_encode(bits)
    got = turbo.turbo_encode(torch.from_numpy(bits))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(turbo.rsc_encode(bits)[0], ref_turbo.rsc_encode(bits)[0])


def test_bcjr_and_turbo_decode_equal_reference():
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (2, 96))
    pi = ref_turbo.default_interleaver(96)
    sigma = np.sqrt(1 / (2 * 10 ** (-0.5 / 10)))
    coded = [np.stack(x) for x in zip(*[ref_turbo.turbo_encode(b, pi)[:3] for b in bits])]
    llrs = [(2 * ((1 - 2.0 * x) + rng.normal(0, sigma, x.shape)) / sigma ** 2).astype(np.float32)
            for x in coded]
    ext = turbo._bcjr_maxlog(*[torch.from_numpy(x) for x in llrs[:2]], torch.zeros(2, 96))
    np.testing.assert_array_equal(ext.numpy(), np.asarray(ref_turbo._bcjr_maxlog(
        jnp.asarray(llrs[0]), jnp.asarray(llrs[1]), jnp.zeros((2, 96)))))
    hard, post = ref_turbo.turbo_decode(*[jnp.asarray(x) for x in llrs], pi, iters=3)
    got_hard, got_post = turbo.turbo_decode(*[torch.from_numpy(x) for x in llrs], pi, iters=3)
    np.testing.assert_array_equal(got_hard.numpy(), np.asarray(hard))
    np.testing.assert_array_equal(got_post.numpy(), np.asarray(post))


# ---------------------------------------------------------------- max-log-MAP


@pytest.mark.parametrize("constraint,polys,terminated", [
    (7, (0o171, 0o133), True), (7, (0o171, 0o133), False), (3, (0o7, 0o5), True),
    (7, (0o133, 0o171, 0o165), False)])
def test_map_decode_equals_reference(constraint, polys, terminated):
    rng = np.random.default_rng(constraint)
    bits = rng.integers(0, 2, (2, 3, 30)).astype(np.int32)
    coded = np.asarray(ref_conv.conv_encode(jnp.asarray(bits), constraint, polys))
    soft = (1 - 2.0 * coded + 0.9 * rng.standard_normal(coded.shape)).astype(np.float32)
    llr, hard = ref_conv.map_decode(jnp.asarray(soft), constraint, polys, terminated)
    got_llr, got_hard = convolutional.map_decode(torch.from_numpy(soft), constraint, polys,
                                                 terminated)
    assert got_llr.shape == llr.shape and got_hard.dtype == torch.int32
    np.testing.assert_array_equal(got_llr.numpy(), np.asarray(llr))
    np.testing.assert_array_equal(got_hard.numpy(), np.asarray(hard))


# ---------------------------------------------------------------- polar


@pytest.mark.parametrize("n,k,snr_db", [(128, 64, 2.0), (64, 20, 0.0)])
def test_polar_encode_decode_match_reference(n, k, snr_db):
    np.testing.assert_array_equal(polar.frozen_mask(n, k), ref_polar.frozen_mask(n, k))
    bits = np.random.default_rng(n + k).integers(0, 2, (3, k))
    cw = np.asarray(ref_polar.polar_encode(jnp.asarray(bits), n, k))
    got = polar.polar_encode(torch.from_numpy(bits), n, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), cw)
    llr = _noisy_llr(cw, snr_db, k)
    np.testing.assert_array_equal(polar.polar_decode(torch.from_numpy(llr), n, k),
                                  ref_polar.polar_decode(llr, n, k))


# ---------------------------------------------------------------- TCM


def _tcm_rx(n_bits: int, ebn0_db: float, seed: int):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_bits).astype(np.int32)
    _, tx = ref_tcm.tcm_encode(bits)
    sigma = np.sqrt(1.0 / (2.0 * 10.0 ** (ebn0_db / 10.0) * 2.0))
    noise = (rng.standard_normal(tx.shape[-1]) + 1j * rng.standard_normal(tx.shape[-1])) * sigma
    return bits, np.array(tx + noise.astype(np.complex64))


def test_tcm_encode_matches_reference():
    bits = np.random.default_rng(1).integers(0, 2, 2000).astype(np.int32)
    idx, tx = ref_tcm.tcm_encode(bits)
    got_idx, got_tx = tcm.tcm_encode(torch.from_numpy(bits))
    assert got_idx.shape == (1002,) and got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_tx.numpy(), np.asarray(tx))


@pytest.mark.parametrize("ebn0_db,seed", [(5.0, 0), (2.0, 1), (0.0, 2)])
def test_plain_viterbi_on_the_references_metrics_gives_its_bits(ebn0_db, seed):
    """The reference's pair metrics, negated into the kernels' maximised
    layout, through the plain forward and traceback of the K = 3 (7, 5)
    code (0 in state 0, -1e9 elsewhere, ties to the even predecessor):
    the reference's decoded bits exactly."""
    _, rx = _tcm_rx(3000, ebn0_db, seed)
    pts = jnp.asarray(np.exp(1j * np.pi * np.arange(8) / 4.0).astype(np.complex64))
    d2 = jnp.abs(jnp.asarray(rx)[..., None] - pts) ** 2
    smap = jnp.asarray(ref_tcm._SUBSET_MAP)
    d_pair = np.asarray(jnp.minimum(d2[..., smap], d2[..., smap + 4]))
    par_bit = np.asarray((d2[..., smap + 4] < d2[..., smap]).astype(jnp.int32))
    got_pair, got_par = tcm.tcm_branch_metrics(torch.from_numpy(rx))
    # XLA's and torch's complex abs part by an ulp
    np.testing.assert_allclose(got_pair.numpy(), d_pair, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got_par.numpy(), par_bit)
    coded = tcm.tcm_viterbi(torch.from_numpy(d_pair)[None])[0]
    unc = np.take_along_axis(par_bit, tcm._coded_pairs(coded).numpy()[:, None], -1)[:, 0]
    bits = np.stack([unc[:-2], coded.numpy()[:-2]], axis=-1).reshape(-1)
    np.testing.assert_array_equal(bits, np.asarray(ref_tcm.tcm_decode(rx)))


def test_tcm_decode_batches_lanes_as_the_reference_decodes_rows():
    rows = [_tcm_rx(1000, 3.0, s)[1] for s in range(2)]
    got = tcm.tcm_decode(torch.from_numpy(np.stack(rows)))
    for row, rx in zip(got.numpy(), rows):
        np.testing.assert_array_equal(row, np.asarray(ref_tcm.tcm_decode(rx)))


def test_tcm_coding_gain_demo_equals_reference_at_small_size():
    """The JAX test runs 100,000 bits (tests/test_fec.py:270); the plain
    Viterbi loop here takes 8,000 (the card runs the full size in
    chip_smoke.py phase 34)."""
    want = ref_tcm.tcm_coding_gain_demo(5.0, 8_000, seed=2)
    assert tcm.tcm_coding_gain_demo(5.0, 8_000, seed=2, device="cpu") == want


@pytest.mark.cuda
def test_tcm_decode_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Viterbi kernels have no CPU or interpret mode")
    _, rx = _tcm_rx(20_000, 4.0, 3)
    before = viterbi_kernels.viterbi_forward.launches
    card = tcm.tcm_decode(torch.from_numpy(rx).cuda())
    assert viterbi_kernels.viterbi_forward.launches == before + 1
    assert torch.equal(card.cpu(), tcm.tcm_decode(torch.from_numpy(rx)))


# ---------------------------------------------------------------- fountain and rate matching


@pytest.mark.parametrize("k,n,width,seed", [(32, 48, 64, 5), (24, 48, 16, 9), (16, 10, 8, 3)])
def test_lt_encode_matches_reference(k, n, width, seed):
    data = np.random.default_rng(k).integers(0, 2, (k, width)).astype(np.uint8)
    got = fountain.lt_encode(torch.from_numpy(data), n, seed=seed)
    assert got.dtype == torch.int32 and got.shape == (n, width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_fountain.lt_encode(data, n, seed)))
    np.testing.assert_array_equal(fountain.lt_generator(k, n, seed),
                                  ref_fountain.lt_generator(k, n, seed))
    np.testing.assert_allclose(fountain.robust_soliton(k), ref_fountain.robust_soliton(k),
                               rtol=0, atol=0)


def test_raptor_encode_matches_reference():
    data = np.random.default_rng(4).integers(0, 2, (20, 12)).astype(np.uint8)
    got, k_got = fountain.raptor_encode(torch.from_numpy(data), 40, seed=3)
    want, k_want = ref_fountain.raptor_encode(data, 40, seed=3)
    assert k_got == k_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("target", [1, 7, 20, 33, 61])
def test_rate_match_and_dematch_match_reference(target):
    x = np.random.default_rng(target).standard_normal((3, 20)).astype(np.float32)
    got, got_idx = fountain.rate_match(torch.from_numpy(x), target)
    want, want_idx = ref_fountain.rate_match(x, target)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got_idx is None) == (want_idx is None)
    if want_idx is not None:
        np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(fountain.rate_dematch(got, 20).numpy(),
                                  np.asarray(ref_fountain.rate_dematch(np.asarray(want), 20)))
