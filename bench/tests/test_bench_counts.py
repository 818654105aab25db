"""The benchmark's FLOP and byte counts against hand counts."""
import pytest

from fbench import counts


def test_cnn_layers_by_hand():
    # two 3x3 convs on 4x4 images, a pool, a dense layer of 5
    layers = counts.cnn_layers([2, 3], dense=5, n_classes=4, image=4)
    assert layers == [("conv.0", 2.0 * 16 * 3 * 2 * 9),
                      ("conv.1", 2.0 * 16 * 2 * 3 * 9),
                      ("fc1", 2.0 * (2 * 2 * 3) * 5),
                      ("fc2", 2.0 * 5 * 4)]
    fwd, train = counts.cnn_flops([2, 3], 5, 4, 4)
    assert fwd == sum(f for _, f in layers)
    assert train == 3 * fwd - layers[0][1]


def test_paper_cnn():
    fwd, train = counts.cnn_flops([32, 32, 64, 64, 128, 128, 256, 256],
                                  256, 10, 32)
    # 1,769,472 + 18,874,368 + 9,437,184 + 18,874,368 + 9,437,184 +
    # 18,874,368 + 9,437,184 + 18,874,368 + 524,288 + 5,120
    assert fwd == 106_107_904
    assert train == 3 * 106_107_904 - 1_769_472


def test_eq1_bytes_by_hand():
    # 3 pairs of leaves of 10 and 20 floats, 2 models
    assert counts.eq1_bytes(3, [10, 20], 2) == 4 * (3 * 30 + 2 * 3 + 2
                                                    + 2 * 30)


@pytest.mark.parametrize("d,pad", [(1, 128), (128, 128), (129, 256)])
def test_transport_bytes_by_hand(d, pad):
    q = counts.quantize_bytes([(2, d)])
    dq = counts.dequantize_bytes([(2, d)])
    assert q == 2 * (4 * d + pad + 4 * (pad // 128))
    assert dq == q
