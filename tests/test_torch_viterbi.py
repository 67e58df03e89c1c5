"""The port's Viterbi kernel module: dispatch, build and the CUDA kernels.

On the CPU the dispatchers run the plain versions and launch nothing; the
module imports without ``nvcc``; the forward kernel's launch plan and a
numpy model of its warp-per-lane step (shuffle exchange, ballots, words
cut from the ballots) are checked against the plain version, and so are
the traceback's plan and a numpy model of its staged walk (chunks from the
top, a ring of shared-memory stages, four words named by one state). The CUDA
kernels run only on a card: their tests are marked ``cuda``, decide inside
the test whether a card exists, and skip elsewhere. Kernel and plain
version must agree exactly: the kernels do FP32 adds and compares only.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from r4w_tpu_torch.fec import convolutional
from r4w_tpu_torch.kernels import viterbi

REPO = Path(__file__).resolve().parents[1]
CODES = {5: (0o23, 0o35), 7: (0o171, 0o133)}
# every constraint at R = 2, K = 7 at R = 3, and codes whose generators do
# not all tap both ends of the register
ALL_CODES = [(3, (0o7, 0o5)), (4, (0o17, 0o13)), (5, (0o23, 0o35)), (6, (0o53, 0o75)),
             (7, (0o171, 0o133)), (8, (0o247, 0o371)), (7, (0o133, 0o171, 0o165)),
             (4, (0o16, 0o13)), (7, (0o170, 0o133))]
MAX_THREADS, STATIC_SHARED_BYTES = 1024, 48 * 1024


def _branch_metrics(lanes: int, n_info: int, constraint: int, seed: int = 3,
                    sigma: float = 0.4, polys=None) -> torch.Tensor:
    """(T, 2^R, lanes) branch metrics of noisy soft input for the code of `constraint`."""
    polys = CODES[constraint] if polys is None else polys
    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(rng.integers(0, 2, (lanes, n_info)).astype(np.int32))
    coded = convolutional.conv_encode(bits, constraint, polys).numpy()
    soft = (1.0 - 2.0 * coded + sigma * rng.standard_normal(coded.shape)).astype(np.float32)
    return convolutional._branch_metrics(torch.from_numpy(soft).reshape(lanes, -1, len(polys)))


def test_cpu_dispatch_runs_plain_versions_and_launches_nothing():
    bm = _branch_metrics(5, 40, 7)
    before = (viterbi.viterbi_forward.launches, viterbi.viterbi_traceback.launches)
    dec, final = viterbi.viterbi_forward_dispatch(bm, 7, CODES[7])
    want_dec, want_final = viterbi.viterbi_forward(bm, 7, CODES[7])
    assert torch.equal(dec, want_dec) and torch.equal(final, want_final)
    assert torch.equal(viterbi.viterbi_traceback_dispatch(dec, 7, CODES[7]),
                       viterbi.viterbi_traceback(dec, 7, CODES[7]))
    convolutional.viterbi_decode(torch.zeros(5, 92), soft=True)
    convolutional.viterbi_decode(torch.zeros(5, 92), soft=True, terminated=False)
    assert (viterbi.viterbi_forward.launches, viterbi.viterbi_traceback.launches) == before


def test_dispatch_and_wrappers_reject_what_the_kernels_do_not_take():
    bm = _branch_metrics(3, 20, 5)
    dec, _ = viterbi.viterbi_forward(bm, 5, CODES[5])
    before = (viterbi.viterbi_forward.launches, viterbi.viterbi_traceback.launches)
    with pytest.raises(ValueError, match="CUDA"):
        viterbi.viterbi_forward_cuda(bm, 5, CODES[5])
    with pytest.raises(ValueError, match="CUDA"):
        viterbi.viterbi_traceback_cuda(dec, 5, CODES[5])
    with pytest.raises(ValueError, match="K=9"):
        viterbi.viterbi_forward_cuda(bm, 9, (0o561, 0o753))
    with pytest.raises(ValueError, match="R=4"):
        viterbi.viterbi_forward_cuda(bm, 5, (0o23, 0o35, 0o27, 0o31))
    with pytest.raises(ValueError, match="no viterbi_forward path"):
        viterbi.viterbi_forward_dispatch(bm.to("meta"), 5, CODES[5])
    with pytest.raises(ValueError, match="no viterbi_traceback path"):
        viterbi.viterbi_traceback_dispatch(dec.to("meta"), 5, CODES[5])
    assert (viterbi.viterbi_forward.launches, viterbi.viterbi_traceback.launches) == before


@pytest.mark.parametrize("constraint", [3, 5, 7, 8])
def test_decision_words_and_traceback_invert_each_other(constraint):
    """Packing: bit s' mod w of word s' // w; the plain traceback of a clean
    terminated code returns the input bits, flush bits included."""
    polys = {3: (0o7, 0o5), 5: CODES[5], 7: CODES[7], 8: (0o247, 0o371)}[constraint]
    rng = np.random.default_rng(constraint)
    bits = torch.from_numpy(rng.integers(0, 2, (4, 30)).astype(np.int32))
    coded = convolutional.conv_encode(bits, constraint, polys)
    bm = convolutional._branch_metrics((1.0 - 2.0 * coded.float()).reshape(4, -1, 2))
    dec, final = viterbi.viterbi_forward(bm, constraint, polys)
    s = 1 << (constraint - 1)
    assert dec.shape == (bm.shape[0], s // viterbi.word_width(constraint), 4)
    assert final.shape == (s, 4) and int(dec.max()) < (1 << viterbi.word_width(constraint))
    out = viterbi.viterbi_traceback(dec, constraint, polys)
    assert torch.equal(out.T[:, :30], bits) and not out.T[:, 30:].any()


@pytest.mark.parametrize("lanes", [1, 3, 130, 2100, 4096])
@pytest.mark.parametrize("constraint,polys", ALL_CODES[:7])
def test_forward_plan_fits_a_hopper_block(constraint, polys, lanes):
    plan = viterbi.forward_plan(constraint, 1 << len(polys), lanes)
    assert plan.group == min(1 << (constraint - 2), 32)
    assert plan.lanes_per_block >= 1 and plan.chunk >= 1
    assert plan.threads == plan.group * plan.lanes_per_block
    assert plan.threads % 32 == 0 and plan.threads <= MAX_THREADS  # whole warps for the shuffles
    assert plan.smem_bytes <= STATIC_SHARED_BYTES
    if lanes >= 2100:
        assert plan.threads == viterbi.BLOCK_THREADS or plan.lanes_per_block == 32


def _forward_model(bm: np.ndarray, constraint: int, polys) -> tuple[np.ndarray, np.ndarray]:
    """numpy model of csrc/viterbi.cu's forward kernel, step by step: thread g of
    a lane holds states g + u*G; two shuffles a slot pair fetch the sources;
    ballots are laid out by thread index in the plan's blocks and the words
    are cut from them as the kernel's write-out does."""
    steps, n_codes, lanes = bm.shape
    s = 1 << (constraint - 1)
    plan = viterbi.forward_plan(constraint, n_codes, lanes)
    group, block = plan.group, plan.lanes_per_block
    slots, pairs = s // group, s // group // 2
    width, n_words = viterbi.word_width(constraint), s // viterbi.word_width(constraint)
    code = viterbi.code_index(constraint, tuple(polys))
    g = np.arange(group)
    high, odd = (2 * g >= group)[:, None], (g % 2 == 1)[:, None]
    src_first = np.where(2 * g >= group, 2 * g + 1, 2 * g) % group
    src_second = np.where(2 * g >= group, 2 * g, 2 * g + 1) % group
    metric = np.full((slots, group, lanes), np.float32(-1e9), np.float32)
    metric[0, 0] = 0.0
    lane = np.arange(lanes)
    thread = (lane % block)[None, :] * group + g[:, None]  # (G, L): thread index in the block
    dec = np.zeros((steps, n_words, lanes), np.int64)
    for t in range(steps):
        new, ballot_bits = np.empty_like(metric), np.zeros((slots, group, lanes), np.int64)
        for q in range(pairs):
            low, upper = metric[2 * q], metric[2 * q + 1]
            first = np.where(odd, upper, low)[src_first]
            second = np.where(odd, low, upper)[src_second]
            from_even, from_odd = np.where(high, second, first), np.where(high, first, second)
            m = g + q * group
            for b in range(2):
                a = from_even + bm[t][code[2 * m, b]]
                o = from_odd + bm[t][code[2 * m + 1, b]]
                new[q + b * pairs] = np.where(o > a, o, a)
                ballot_bits[q + b * pairs] = (o > a).astype(np.int64) << (thread % 32)
        metric = new
        # each warp's ballot u, then the write-out's cut of lane l's words
        warp = (lane % block) * group // 32
        ballots = np.zeros((slots, lanes), np.int64)
        for u in range(slots):
            per_warp = {}
            for l in range(lanes):
                key = (l // block, warp[l])
                per_warp[key] = per_warp.get(key, 0) | int(ballot_bits[u, :, l].sum())
            ballots[u] = [per_warp[(l // block, warp[l])] for l in range(lanes)]
        for w in range(n_words):
            if group == 32:
                dec[t, w] = (ballots[w // 2] >> (16 * (w % 2))) & 0xFFFF
            else:
                seg = (lane % block) * group % 32
                mask = (1 << group) - 1
                bits = ((ballots[0] >> seg) & mask) | (((ballots[1] >> seg) & mask) << group)
                dec[t, w] = bits if n_words == 1 else (bits >> (16 * w)) & 0xFFFF
    final = np.stack([metric[u, gg] for u in range(slots) for gg in range(group)])
    return dec.astype(np.int32), final


@pytest.mark.parametrize("constraint,polys", ALL_CODES)
def test_forward_model_equals_plain_version(constraint, polys):
    bm = _branch_metrics(37, 40, constraint, seed=constraint, polys=polys)
    dec, final = _forward_model(bm.numpy(), constraint, polys)
    want_dec, want_final = viterbi.viterbi_forward(bm, constraint, polys)
    np.testing.assert_array_equal(dec, want_dec.numpy())
    np.testing.assert_array_equal(final, want_final.numpy())


@pytest.mark.parametrize("lanes", [1, 3, 33, 130, 4096, 100_000])
@pytest.mark.parametrize("constraint", range(3, 9))
def test_traceback_plan_fits_a_hopper_block(constraint, lanes):
    plan = viterbi.traceback_plan(constraint, lanes)
    words = (1 << (constraint - 1)) // viterbi.word_width(constraint)
    row_bytes = 4 * viterbi.TRACEBACK_LANES * words
    assert viterbi.TRACEBACK_LANES == 32  # one whole warp, a thread per lane
    assert plan.chunk * row_bytes <= viterbi.TRACEBACK_CHUNK_BYTES
    assert plan.chunk >= 4 and plan.stages >= 2
    assert plan.smem_bytes == plan.stages * plan.chunk * row_bytes <= STATIC_SHARED_BYTES
    assert (plan.blocks - 1) * 32 < lanes <= plan.blocks * 32 and plan.blocks < 2 ** 31
    if constraint == 7:
        assert plan.chunk == 32 and plan.stages == 3
    if constraint == 8:
        assert plan.chunk == 16


@pytest.mark.parametrize("n_rows", [1, 5, 64, 128])
@pytest.mark.parametrize("lb", [1, 2, 3, 20, 31, 32])
def test_traceback_copy_walk_stages_each_pair_once(lb, n_rows):
    """The traceback's 4-byte staging (csrc/viterbi.cu:stage_decisions): each
    of the 32 threads steps through the row-major (n_rows, lb) pairs 32 apart
    by adding 32 // lb rows and 32 % lb lanes, with a carry; together they
    stage every pair exactly once."""
    block = viterbi.TRACEBACK_LANES
    seen = np.zeros((n_rows, lb), np.int64)
    for thread in range(block):
        row, lane = divmod(thread, lb)
        while row < n_rows:
            seen[row, lane] += 1
            row, lane = row + block // lb, lane + block % lb
            if lane >= lb:
                row, lane = row + 1, lane - lb
    assert (seen == 1).all()


def _traceback_model(dec: np.ndarray, constraint: int, start=None) -> np.ndarray:
    """numpy model of csrc/viterbi.cu's traceback under `traceback_plan`:
    blocks of 32 lanes walk chunks cut at multiples of the chunk from step
    0, the ragged top one first; walk k's chunk lands in ring stage k mod
    stages, laid out as the kernel's shared memory, (t·G + w)·32 + lane,
    while the next stages - 1 chunks are staged ahead; the state at the top
    of a group of four steps names the rows of all four, and each step reads
    its word from the stage by that address."""
    steps, n_words, lanes = dec.shape
    s = 1 << (constraint - 1)
    width = viterbi.word_width(constraint)
    plan = viterbi.traceback_plan(constraint, lanes)
    block = viterbi.TRACEBACK_LANES
    chunk, stages = plan.chunk, plan.stages
    stage_ints = chunk * n_words * block
    assert 4 * stages * stage_ints == plan.smem_bytes
    lane = np.arange(plan.blocks * block)
    blk, l = lane // block, lane % block
    padded = np.zeros((steps, n_words, lane.size), np.int64)
    padded[..., :lanes] = dec
    ring = np.full((plan.blocks, stages * stage_ints), -1, np.int64)
    n_chunks = -(-steps // chunk)
    state = np.zeros(lane.size, np.int64)
    if start is not None:
        state[:lanes] = start & (s - 1)
    bits = np.full((steps, lanes), -1, np.int64)

    def stage_walk(k):
        t0 = (n_chunks - 1 - k) * chunk
        n = min(chunk, steps - t0)
        rows = padded[t0:t0 + n].reshape(n * n_words, plan.blocks, block).transpose(1, 0, 2)
        base = (k % stages) * stage_ints
        ring[:, base:base + stage_ints] = -1  # nothing of the chunk it replaces survives
        ring[:, base:base + n * n_words * block] = rows.reshape(plan.blocks, -1)

    def step(t, word):
        nonlocal state
        assert (word >= 0).all()  # read from the chunk being walked
        bits[t] = state[:lanes] >> (constraint - 2)
        state = ((state << 1) & (s - 2)) | ((word >> (state % width)) & 1)

    for k in range(min(stages - 1, n_chunks)):
        stage_walk(k)
    for k in range(n_chunks):
        if k + stages - 1 < n_chunks:
            stage_walk(k + stages - 1)
        t0 = (n_chunks - 1 - k) * chunk
        n = min(chunk, steps - t0)
        base = (k % stages) * stage_ints
        top = n - 1
        while top >= 3:  # whole groups of four: the state at the top names their rows
            rows = [((state << p) & (s - 1)) // width for p in range(4)]
            words = [ring[blk, base + ((top - p) * n_words + rows[p]) * block + l]
                     for p in range(4)]
            for p in range(4):
                step(t0 + top - p, words[p])
            top -= 4
        for t in range(top, -1, -1):  # the chunk's last few steps, one at a time
            step(t0 + t, ring[blk, base + (t * n_words + state // width) * block + l])
    return bits.astype(np.int32)


@pytest.mark.parametrize("steps", [37, 300, 2054])
@pytest.mark.parametrize("constraint,polys", ALL_CODES[:7])
def test_traceback_model_equals_plain_version(constraint, polys, steps):
    """Random decision words (every path through the words, not only a
    decoder's), lanes 1/3/33/130 (a block, ragged blocks), T not a multiple
    of any chunk but at 2054, with and without a start state."""
    s, width = 1 << (constraint - 1), viterbi.word_width(constraint)
    for lanes in (1, 3, 33, 130):
        rng = np.random.default_rng(steps * lanes + constraint)
        dec = rng.integers(0, 1 << width, (steps, s // width, lanes)).astype(np.int32)
        for start in (None, rng.integers(0, s, lanes).astype(np.int32)):
            want = viterbi.viterbi_traceback(torch.from_numpy(dec), constraint, polys,
                                             None if start is None else torch.from_numpy(start))
            got = _traceback_model(dec, constraint, start)
            np.testing.assert_array_equal(got, want.numpy(), err_msg=f"lanes {lanes}")


def test_module_imports_without_nvcc():
    code = ("import sys\n"
            "import r4w_tpu_torch.kernels.viterbi as v\n"
            "import r4w_tpu_torch.fec, r4w_tpu_torch.ops.stream_math\n"
            "from r4w_tpu_torch.kernels import _build, fir, nco, recurrence\n"
            "assert _build.load_library.cache_info().currsize == 0\n"
            "assert v._kernels.cache_info().currsize == 0\n"
            "assert fir._kernel.cache_info().currsize == nco._kernel.cache_info().currsize == 0\n"
            "assert recurrence._kernel.cache_info().currsize == 0\n"
            "assert 'triton' not in sys.modules\n"
            "assert sorted(_build.sources()) == ['dechirp_power', 'fir_decimate', "
            "'first_order_iir', 'nco_mix', 'viterbi']\n"
            "try:\n"
            "    _build._nvcc()\n"
            "except RuntimeError as e:\n"
            "    print('no nvcc:', e)\n"
            "else:\n"
            "    raise SystemExit('nvcc was found')\n")
    env = {**os.environ, "PATH": os.path.dirname(sys.executable), "CUDA_HOME": str(REPO / "absent"),
           "CUDA_PATH": str(REPO / "absent")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no nvcc" in proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n_info,constraint", [(130, 505, 7), (2100, 24, 5)])
def test_kernels_equal_plain_versions_on_card(lanes, n_info, constraint):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    polys = CODES[constraint]
    bm = _branch_metrics(lanes, n_info, constraint).cuda()
    before = (viterbi.viterbi_forward.launches, viterbi.viterbi_traceback.launches)
    dec, final = viterbi.viterbi_forward_cuda(bm, constraint, polys)
    want_dec, want_final = viterbi.viterbi_forward(bm, constraint, polys)
    start = torch.argmax(final, dim=0).to(torch.int32)
    for state in (None, start):
        got = viterbi.viterbi_traceback_cuda(dec, constraint, polys, state)
        assert torch.equal(got, viterbi.viterbi_traceback(want_dec, constraint, polys, state))
    torch.cuda.synchronize()
    assert (viterbi.viterbi_forward.launches, viterbi.viterbi_traceback.launches) == (
        before[0] + 1, before[1] + 2)
    assert torch.equal(dec, want_dec) and torch.equal(final, want_final)


@pytest.mark.cuda
@pytest.mark.parametrize("constraint,polys", ALL_CODES)
def test_forward_kernel_on_ragged_shapes_on_card(constraint, polys):
    """Lanes 1/3/130/2100 (one-warp and full blocks, ragged last block) and
    T not a multiple of the staging chunk, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    for lanes in (1, 3, 130, 2100):
        for steps in (37, 300):
            bm = _branch_metrics(lanes, steps - constraint + 1, constraint, seed=steps + lanes,
                                 polys=polys).cuda()
            dec, final = viterbi.viterbi_forward_cuda(bm, constraint, polys)
            want_dec, want_final = viterbi.viterbi_forward(bm, constraint, polys)
            torch.cuda.synchronize()
            assert torch.equal(dec, want_dec) and torch.equal(final, want_final), (lanes, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 33, 4096])
@pytest.mark.parametrize("constraint,polys", ALL_CODES[:7])
def test_traceback_kernel_on_ragged_shapes_on_card(constraint, polys, lanes):
    """Random decision words, T ragged against every chunk and at the decode
    bench's 2054, with and without a start state, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    s, width = 1 << (constraint - 1), viterbi.word_width(constraint)
    for steps in (37, 300, 2054):
        rng = np.random.default_rng(steps * lanes + constraint)
        dec = torch.from_numpy(rng.integers(0, 1 << width, (steps, s // width, lanes))
                               .astype(np.int32)).cuda()
        start = torch.from_numpy(rng.integers(0, s, lanes).astype(np.int32)).cuda()
        for state in (None, start):
            before = viterbi.viterbi_traceback.launches
            got = viterbi.viterbi_traceback_cuda(dec, constraint, polys, state)
            want = viterbi.viterbi_traceback(dec, constraint, polys, state)
            torch.cuda.synchronize()
            assert viterbi.viterbi_traceback.launches == before + 1
            assert torch.equal(got, want), (steps, state is None)
