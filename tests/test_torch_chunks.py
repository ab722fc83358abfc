"""The port's copies of ``core/chunks.py`` and ``core/volume.py`` are
bit-equal to ``iterseg_tpu.core`` on the cases of ``tests/test_chunks.py``."""
import numpy as np
import pytest

from iterseg_tpu.core import chunks as jc
from iterseg_tpu.core import volume as jv
from iterseg_tpu_torch.core import chunks as tc
from iterseg_tpu_torch.core import volume as tv

GRID_CASES = [
    ((256, 256, 256), (10, 256, 256), (1, 64, 64)),
    ((10, 64, 64), (10, 64, 64), (1, 8, 8)),
    ((37,), (10,), (2,)),
    ((100,), (10,), (1,)),
    ((64, 80), (16, 32), (2, 4)),
    ((23, 50, 41), (10, 20, 16), (1, 4, 3)),
    ((33, 512, 512), (10, 256, 256), (1, 64, 64)),
    ((10, 96, 96), (10, 64, 64), (1, 16, 16)),
]


@pytest.mark.parametrize("arr,chk,mrg", GRID_CASES)
def test_make_chunks_equal(arr, chk, mrg):
    js, jcr = jc.make_chunks(arr, chk, mrg)
    ts, tcr = tc.make_chunks(arr, chk, mrg)
    np.testing.assert_array_equal(np.asarray(ts), np.asarray(js))
    np.testing.assert_array_equal(np.asarray(tcr), np.asarray(jcr))
    for s in ts:
        assert tc.chunk_slices(s, chk) == jc.chunk_slices(s, chk)


def test_process_chunks_equal():
    vol = np.random.default_rng(0).random((23, 40, 37)).astype(np.float32)

    def f(input_volume, sl):
        return input_volume[sl[1:]][None, None] * 2.0

    outs = []
    for mod in (jc, tc):
        out = np.zeros((1,) + vol.shape, dtype=np.float32)
        mod.process_chunks(vol, (10, 16, 16), out, (1, 4, 4), f)
        outs.append(out)
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1][0], vol * 2.0)


def test_get_slices_from_chunks_equal():
    args = ((3, 20, 32, 32), (10, 16, 16), (1, 4, 4))
    assert tc.get_slices_from_chunks(*args) == jc.get_slices_from_chunks(
        *args)


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_volume_prep_equal(dtype):
    r = np.random.default_rng(1)
    vol = (r.random((8, 20, 24)) * 1000).astype(dtype)
    vol[2] = 0
    vol[:, :, 5] = 0
    jp, jk = jv.prepare_volume(vol, return_kept=True)
    tp, tk = tv.prepare_volume(vol, return_kept=True)
    np.testing.assert_array_equal(tp, jp)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tv.remove_sum_zero_slices(vol), jv.remove_sum_zero_slices(vol))
    np.testing.assert_array_equal(tv.normalise_data(vol.astype(np.float32)),
                                  jv.normalise_data(vol.astype(np.float32)))
    labels = (tp > 0.5).astype(np.int32)
    np.testing.assert_array_equal(
        tv.restore_labels(labels, tk, vol.shape),
        jv.restore_labels(labels, jk, vol.shape))
