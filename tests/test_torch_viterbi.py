"""The port's Viterbi kernel module: dispatch, build and the CUDA kernels.

On the CPU the dispatchers run the plain versions and launch nothing; the
module imports without ``nvcc``. The CUDA kernels run only on a card:
their tests are marked ``cuda``, decide inside the test whether a card
exists, and skip elsewhere. Kernel and plain version must agree exactly:
the kernels do FP32 adds and compares only.
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


def _branch_metrics(lanes: int, n_info: int, constraint: int, seed: int = 3,
                    sigma: float = 0.4) -> torch.Tensor:
    """(T, 4, lanes) branch metrics of noisy soft input for the code of `constraint`."""
    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(rng.integers(0, 2, (lanes, n_info)).astype(np.int32))
    coded = convolutional.conv_encode(bits, constraint, CODES[constraint]).numpy()
    soft = (1.0 - 2.0 * coded + sigma * rng.standard_normal(coded.shape)).astype(np.float32)
    return convolutional._branch_metrics(torch.from_numpy(soft).reshape(lanes, -1, 2))


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


def test_module_imports_without_nvcc():
    code = ("import sys\n"
            "import r4w_tpu_torch.kernels.viterbi as v\n"
            "import r4w_tpu_torch.fec, r4w_tpu_torch.ops.stream_math\n"
            "from r4w_tpu_torch.kernels import _build, fir, nco\n"
            "assert _build.load_library.cache_info().currsize == 0\n"
            "assert v._kernels.cache_info().currsize == 0\n"
            "assert fir._kernel.cache_info().currsize == nco._kernel.cache_info().currsize == 0\n"
            "assert 'triton' not in sys.modules\n"
            "assert sorted(_build.sources()) == ['dechirp_power', 'fir_decimate', 'nco_mix', "
            "'viterbi']\n"
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
