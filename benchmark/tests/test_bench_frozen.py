"""The frozen copies the references use, held to known answers (computed
from the port at the commit that froze them) and to the port itself."""

import torch

from benchmark import frozen


def test_philox_known_answers():
    w = frozen.dropout_keep_bits(3, 6, 12345, row0=(1 << 32) + 5)
    assert w.tolist() == [
        [790079223, 1342980056, 4227581050, 1001904803, 663791764,
         1862946899],
        [400575756, 1952896695, 630145682, 2837578163, 1685932476,
         3945098083],
        [3336092139, 564900203, 3751173877, 3588697783, 1178691833,
         2282307703]]


def test_layer_seed_wraps_to_int32():
    assert frozen.layer_seed(2 ** 31 - 1, 1) == -(2 ** 31) + 7918
    assert frozen.keep_threshold(0.2) == int(0.2 * 2 ** 32)


def test_mask_equals_the_ports():
    from latent_diffusion_models_for_shape_sdfs_torch.ops import (
        relu_dropout as rd)
    for seed, rows, cols, row0 in ((2 ** 31 + 77, 1000, 253, 0),
                                   (5, 300, 512, 70_000)):
        s = frozen.layer_seed(seed, 3)
        assert s == rd.layer_seed(seed, 3)
        assert torch.equal(frozen.dropout_keep_mask(rows, cols, s, 0.2,
                                                    row0=row0),
                           rd.dropout_keep_mask(rows, cols, s, 0.2,
                                                row0=row0))


def test_chairs_known_answers():
    _, ch = frozen.make_chairs(5, 99)
    assert ch.box_b[0].tolist() == [
        [0.5351577401161194, 0.04682397097349167, 0.45224857330322266],
        [0.5351577401161194, 0.23488526046276093, 0.055495571345090866]]
    assert ch.cap_r[0].tolist() == [0.038022130727767944] * 4
    d = frozen.chair_sdf(ch, torch.tensor([[[0.0, 0.0, 0.0],
                                            [0.5, 0.5, 0.5]]] * 5))
    assert d[0].tolist() == [-0.008744906634092331, 0.4178345501422882]


def test_chairs_equal_the_ports_packing_and_sdf():
    from latent_diffusion_models_for_shape_sdfs_torch.data import (
        analytic, analytic_device as adv)
    trees, ch = frozen.make_chairs(7, 3)
    assert all(torch.equal(a, b) for a, b in zip(adv.pack_chairs(trees), ch))
    x = torch.rand(7, 200, 3, generator=torch.Generator().manual_seed(0))
    x = x * 2.2 - 1.1
    assert torch.equal(adv.chair_sdf(adv.pack_chairs(trees), x),
                       frozen.chair_sdf(ch, x))
    host = analytic.sdf(trees[2], x[2].numpy())
    assert torch.allclose(frozen.chair_sdf(ch, x)[2],
                          torch.from_numpy(host).float(), atol=1e-6)
