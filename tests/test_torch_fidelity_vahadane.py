"""The port's Vahadane golden anchors: the fused Vahadane output and the
stain matrix against the sklearn golden (``tests/cpu_reference.py``), the
counterparts of ``tests/test_fidelity.py:56-96``. The fused kernel runs as
its plain version on the CPU. Budgets: delta-E < 1.0, and a cosine above
0.999 per stain row.
"""

import pytest
import torch
from threadpoolctl import threadpool_limits

from stainlib_tpu_torch.extraction.vahadane import stain_matrix_vahadane
from stainlib_tpu_torch.kernels.vahadane_fused import vahadane_normalize
from stainlib_tpu_torch.normalization import extractive
from tests import cpu_reference as ref
from tests.synth import he_patch
from tests.test_torch_fidelity import _golden_normalize


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """The golden's per-pixel scipy QPs and sklearn's learner run on one
    BLAS thread: with several test workers on the host, idle BLAS threads
    spinning in each of them slow the whole run many times over."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def vahadane_golden():
    """The sklearn golden of the Vahadane test pair (about 10 s a matrix,
    computed once for the two tests that read it)."""
    target = he_patch(48, 64, seed=124)
    src = he_patch(48, 64, seed=125)
    want, Ms = _golden_normalize(target, src, ref.vahadane_stain_matrix)
    return target, src, want, Ms


def test_fused_vahadane_delta_e_vs_cpu_golden(vahadane_golden):
    target, src, want, _ = vahadane_golden
    params = extractive.fit(torch.from_numpy(target), method="vahadane")
    got = vahadane_normalize(torch.from_numpy(src)[None],
                             params.stain_matrix_target,
                             params.max_c_target)[0].numpy()
    de = ref.delta_e(got, want)
    assert de < 1.0, de


def test_vahadane_stain_matrix_vs_sklearn_golden(vahadane_golden):
    """The BCD dictionary lands near the sklearn optimum (cosine per stain
    row), which anchors the matrix, not just the pixels."""
    _, src, _, want = vahadane_golden
    got = stain_matrix_vahadane(torch.from_numpy(src)[None])[0].numpy()
    cos = (got * want).sum(-1)  # both row-normalized
    assert (cos > 0.999).all(), (cos, got, want)
