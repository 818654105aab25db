"""The frozen input generators: the same seed gives the same arrays,
and they are the program's own generators' arrays."""
import hashlib

import numpy as np
import pytest

from fbench import frozen


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def test_population_repeats_and_varies():
    a = frozen.hierarchical_population(7, 1, (0.6, 0.7), 8, 4, 4, 2.0)
    b = frozen.hierarchical_population(7, 1, (0.6, 0.7), 8, 4, 4, 2.0)
    c = frozen.hierarchical_population(8, 1, (0.6, 0.7), 8, 4, 4, 2.0)
    assert _digest(*a["train"], *a["val"]) == _digest(*b["train"],
                                                      *b["val"])
    assert _digest(*a["train"]) != _digest(*c["train"])
    assert a["train"][0].shape == (10, 8, 32, 32, 3)
    assert a["train"][0].dtype == np.float32
    assert a["test"][1].dtype == np.int32


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 11])
def test_population_is_the_programs(seed):
    from repro_torch.data.partition import (hierarchical_devices,
                                            stack_devices)
    ours = frozen.hierarchical_population(seed, 1, (0.6, 0.7), 16, 8, 8,
                                          2.0)
    theirs = stack_devices(hierarchical_devices(
        seed=seed, devices_per_archetype=1, n_train=16, n_val=8, n_test=8))
    for split in ("train", "val", "test"):
        for a, b in zip(ours[split], theirs[split]):
            np.testing.assert_array_equal(a, b)


def test_samples_are_the_programs():
    from repro_torch.federated.simulation import draw_round_sample
    ours = frozen.round_samples(2**31 + 5, 3, 10, 4, 64, 32, 2)
    rng = np.random.default_rng(2**31 + 5)
    for t in (1, 2, 3):
        part, perms = draw_round_sample(rng, 10, 4, 64, 32, 2)
        np.testing.assert_array_equal(part, ours[t][0])
        np.testing.assert_array_equal(perms, ours[t][1])
        assert ours[t][0].sum() == 4 and ours[t][1].shape == (10, 4, 32)
