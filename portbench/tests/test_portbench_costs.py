"""The yardstick's frozen arithmetic (``portbench/lib/costs.py``) tied
to the program's counts of today at small sizes: the stacked MNet's
FLOPs (``utils/flops.py``), the FLOPs of a whole train step (the
program's counter over ``train_step``, backward included), K1's
operations and bytes and ``hshear``'s bytes (``chip_smoke.py``)."""

import pytest
import torch

from portbench.lib import costs
from portbench.reference import augment as ref_augment


@pytest.mark.parametrize("h,w,ngf", [(64, 96, 8), (256, 256, 64)])
def test_stacked_mnet_flops(h, w, ngf):
    from shadow_removal_istd_tpu_torch.utils.flops import stacked_mnet_flops

    assert costs.stacked_mnet_flops(h, w, ngf) == stacked_mnet_flops(h, w, ngf=ngf)


@pytest.mark.parametrize("net_g,net_d,crop,visual", [
    ("mnet", "patchgan", 64, True), ("stcgan", "stcgan", 256, False)])
def test_train_step_flops(net_g, net_d, crop, visual):
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.state import init_state
    from shadow_removal_istd_tpu_torch.engine.steps import train_step
    from shadow_removal_istd_tpu_torch.models.vgg import VGG19Features, init_vgg_
    from shadow_removal_istd_tpu_torch.utils.flops import count_flops

    cfg = TrainConfig(net_g=net_g, net_d=net_d, ngf=4, ndf=4, image_size=crop, batch_size=2,
                      use_visual_loss=visual, lambda4=5.0 if visual else 0.0,
                      lambda5=50.0 if visual else 0.0)
    vgg = init_vgg_(VGG19Features(), torch.Generator().manual_seed(1)) if visual else None
    state = init_state(cfg, torch.Generator().manual_seed(0), "cpu", vgg=vgg)
    batch = tuple(torch.rand(2, c, crop, crop) * 2 - 1 for c in (3, 1, 3))
    gens = (torch.Generator().manual_seed(2), torch.Generator().manual_seed(3))
    got = count_flops(lambda: train_step(state, batch, gens))
    assert got == 2 * costs.train_step_flops_per_image(net_g, net_d, crop, crop, 4, 4, visual)


def test_k1_cost_and_steps_are_chip_smokes():
    import chip_smoke

    for h, w, ngf in ((256, 256, 64), (480, 640, 64), (64, 96, 8)):
        for cout in (1, 3):
            ours = costs.mnet_decoder_steps(h, w, ngf, cout)
            theirs = [s for s in chip_smoke.decoder_steps(h, w, ngf)
                      if not s[5] or s[4] == cout]
            assert [(s[1], s[2], s[3], s[4], s[5]) for s in theirs] == ours
            for n in (1, 8, 32):
                for sh, sw, parts, co, final in ours:
                    assert costs.k1_cost(n, sh, sw, parts, co, final) == tuple(
                        float(v) for v in chip_smoke.step_cost(n, sh, sw, parts, co, final, 2))


def test_hshear_bytes_are_chip_smokes():
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    params = ref_augment.draw_params(gen, 3, 48, 64, 0.05, 15.0, 32, "cpu")
    for shifts, out_w, pad, src_w in ref_augment.shear_shifts(params, 48, 64, 32, 15.0):
        src = torch.zeros(3, 7, shifts.shape[1], src_w)
        _, want = chip_smoke.shear_cost(src, shifts.contiguous(), out_w, pad)
        assert costs.hshear_bytes(shifts, 7, src_w, out_w, pad) == want


def test_shear_geometry_is_the_programs():
    from shadow_removal_istd_tpu_torch.ops.shear import shear_geometry

    for h, w, a in ((480, 640, 15.0), (64, 96, 15.0), (256, 256, 30.0)):
        assert costs.shear_geometry(h, w, a) == shear_geometry(h, w, a)
        assert ref_augment.geometry(h, w, a) == shear_geometry(h, w, a)
