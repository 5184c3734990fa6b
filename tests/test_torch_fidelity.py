"""The port's golden anchors: its outputs against the independent CPU
golden (``tests/cpu_reference.py``: numpy, OpenCV, scipy and sklearn, no
code shared with the port).

The counterparts of ``tests/test_normalization.py:42-59`` (the functional
Macenko path against the cv2/scipy golden) and ``tests/test_fidelity.py:
20-96`` (the fused Macenko and Reinhard outputs here; the Vahadane ones
and the Vahadane stain matrix against the sklearn golden in
``tests/test_torch_fidelity_vahadane.py``). The fused kernels run as their
plain versions here: the wrappers take them for CPU tensors. Budgets: the
parity contract's delta-E < 1.0 (``BASELINE.json``), measured with the
golden's own ``delta_e``, and a cosine above 0.999 per stain row.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from stainlib_tpu_torch.kernels.macenko_fused import macenko_normalize
from stainlib_tpu_torch.kernels.reinhard_fused import reinhard_normalize
from stainlib_tpu_torch.normalization import extractive, reinhard
from stainlib_tpu_torch.ops.delta_e import mean_delta_e
from tests import cpu_reference as ref
from tests.synth import he_patch


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """The golden's per-pixel scipy QPs and sklearn's learner run on one
    BLAS thread: with several test workers on the host, idle BLAS threads
    spinning in each of them slow the whole run many times over."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _golden_normalize(target, src, stain_matrix):
    """The extractive pipeline on the golden: matrices from
    ``stain_matrix``, concentrations by the scipy QP, the same rescale."""
    Mt = stain_matrix(target)
    Ct = ref.nonneg_lasso(ref.rgb_to_od(target).reshape(-1, 3), Mt)
    Ms = stain_matrix(src)
    Cs = ref.nonneg_lasso(ref.rgb_to_od(src).reshape(-1, 3), Ms)
    scale = np.percentile(Ct, 99, axis=0) / np.percentile(Cs, 99, axis=0)
    return ref.reconstruct(Cs * scale, Mt, src.shape), Ms


def test_functional_macenko_delta_e_vs_cpu_golden():
    target = he_patch(72, 72, seed=46)
    src = he_patch(72, 72, seed=47)
    params = extractive.fit(torch.from_numpy(target), method="macenko")
    got = extractive.transform(params, torch.from_numpy(src)).numpy()
    want, _ = _golden_normalize(target, src, ref.macenko_stain_matrix)
    assert ref.delta_e(got, want) < 1.0


def test_fused_macenko_delta_e_vs_cpu_golden():
    target = he_patch(48, 64, seed=120)
    src = he_patch(48, 64, seed=121)
    params = extractive.fit(torch.from_numpy(target), method="macenko")
    got = macenko_normalize(torch.from_numpy(src)[None],
                            params.stain_matrix_target,
                            params.max_c_target)[0].numpy()
    want, _ = _golden_normalize(target, src, ref.macenko_stain_matrix)
    de = ref.delta_e(got, want)
    assert de < 1.0, de


@pytest.mark.parametrize("fused", [False, True], ids=["functional", "K5"])
def test_reinhard_delta_e_vs_cpu_golden(fused):
    target = he_patch(64, 64, seed=122)
    src = he_patch(64, 64, seed=123)
    params = reinhard.fit(torch.from_numpy(target))
    x = torch.from_numpy(src)[None]
    got = (reinhard_normalize(x, params.means, params.stds) if fused
           else reinhard.transform(params, x))[0].numpy()
    want = ref.reinhard_transform(src, *ref.reinhard_fit(target))
    de = ref.delta_e(got, want)
    assert de < 1.0, de
    # The port's own delta-E (ops/delta_e.py, CIE76 on float LAB) agrees
    # with the golden's OpenCV 8-bit one on the size of the error.
    assert float(mean_delta_e(torch.from_numpy(got),
                              torch.from_numpy(want))) < 1.0
