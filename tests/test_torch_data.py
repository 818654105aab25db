"""Port parity: the synthetic data and partitions are byte-identical to
the reference's for a seed (both are numpy)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import partition as jp  # noqa: E402
from repro.data import synthetic as js  # noqa: E402
from repro_torch.data import partition as tp  # noqa: E402
from repro_torch.data import synthetic as ts  # noqa: E402


def _same_devices(a, b):
    assert len(a) == len(b)
    for da, db in zip(a, b):
        assert da.archetype == db.archetype
        for split in ("train", "val", "test"):
            for xa, xb in zip(getattr(da, split), getattr(db, split)):
                assert xa.dtype == xb.dtype and xa.shape == xb.shape
                assert xa.tobytes() == xb.tobytes()


def test_class_templates_identical():
    assert js.class_templates().tobytes() == ts.class_templates().tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_hierarchical_devices_identical(seed):
    kw = dict(seed=seed, devices_per_archetype=1, n_train=64, n_val=32,
              n_test=32)
    a, b = jp.hierarchical_devices(**kw), tp.hierarchical_devices(**kw)
    _same_devices(a, b)
    sa, sb = jp.stack_devices(a), tp.stack_devices(b)
    for split in ("train", "val", "test"):
        for xa, xb in zip(sa[split], sb[split]):
            assert xa.dtype == xb.dtype and xa.tobytes() == xb.tobytes()


def test_hierarchical_devices_default_sizes_identical():
    """The chip run's data: 30 devices at 512/128/128 examples."""
    _same_devices(jp.hierarchical_devices(seed=0),
                  tp.hierarchical_devices(seed=0))


def test_hypergeometric_and_dirichlet_identical():
    kw = dict(seed=1, n_train=16, n_val=8, n_test=8)
    _same_devices(jp.hypergeometric_devices(devices_per_archetype=1, **kw),
                  tp.hypergeometric_devices(devices_per_archetype=1, **kw))
    _same_devices(jp.dirichlet_devices(n_devices=5, alpha=0.5, **kw),
                  tp.dirichlet_devices(n_devices=5, alpha=0.5, **kw))


def test_global_dataset_identical():
    a = js.make_global_dataset(seed=2, scale=0.01)
    b = ts.make_global_dataset(seed=2, scale=0.01)
    for split in ("train", "val", "test"):
        for xa, xb in zip(a[split], b[split]):
            assert xa.tobytes() == xb.tobytes()
    np.testing.assert_array_equal(a["train"][1], b["train"][1])
