"""torchvision VGG-19-BN -> ``.npz`` weight conversion; port of
``shadow_removal_istd_tpu/tools/convert_vgg.py``.

The visual loss (reference src/loss.py:40-41) needs torchvision's
pretrained ``vgg19_bn.features[:40]``. This converts a local copy of its
weights into the ``.npz`` layout both packages read (the port's
``models/vgg.py::load_vgg_npz``, the JAX package's
``load_vgg_variables``): conv kernels OIHW -> HWIO, BatchNorm
weight/bias/running_mean/running_var -> scale/bias/mean/var::

    python -m shadow_removal_istd_tpu_torch.tools.convert_vgg \\
        --state-dict vgg19_bn-c79401a0.pth --out vgg19_bn.npz

``--state-dict`` takes the raw torchvision checkpoint (``features.``
keys) or a features-only state dict. Unlike the JAX tool, nothing is
downloaded: without ``--state-dict`` the tool raises.
"""

from __future__ import annotations

import argparse

import numpy as np

# vgg19_bn.features[:40]: the (conv, bn) layer indices
CONV_BN_INDICES = [(0, 1), (3, 4), (7, 8), (10, 11), (14, 15), (17, 18),
                   (20, 21), (23, 24), (27, 28), (30, 31), (33, 34),
                   (36, 37)]


def convert_state_dict(state_dict: dict) -> dict[str, np.ndarray]:
    """torch ``vgg19_bn.features`` state dict -> the flat ``.npz`` dict."""
    out: dict[str, np.ndarray] = {}
    for i, (ci, bi) in enumerate(CONV_BN_INDICES):
        w = np.asarray(state_dict[f"{ci}.weight"])         # (O, I, H, W)
        out[f"conv{i}_kernel"] = w.transpose(2, 3, 1, 0)    # (H, W, I, O)
        out[f"conv{i}_bias"] = np.asarray(state_dict[f"{ci}.bias"])
        out[f"bn{i}_scale"] = np.asarray(state_dict[f"{bi}.weight"])
        out[f"bn{i}_bias"] = np.asarray(state_dict[f"{bi}.bias"])
        out[f"bn{i}_mean"] = np.asarray(state_dict[f"{bi}.running_mean"])
        out[f"bn{i}_var"] = np.asarray(state_dict[f"{bi}.running_var"])
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Convert torchvision vgg19_bn weights to npz")
    parser.add_argument("--out", default="vgg19_bn.npz")
    parser.add_argument("--state-dict", default=None,
                        help="path to a saved vgg19_bn state dict (.pth; "
                             "full-model 'features.' keys or features "
                             "only); required: nothing is downloaded")
    args = parser.parse_args(argv)
    if not args.state_dict:
        raise SystemExit(
            "convert_vgg downloads nothing: pass --state-dict PATH, a "
            "local copy of torchvision's vgg19_bn weights "
            "(vgg19_bn-c79401a0.pth)")

    import torch

    sd = torch.load(args.state_dict, map_location="cpu", weights_only=True)
    # the raw torchvision checkpoint has full-model keys
    # ("features.0.weight"); a features-only dict has "0.weight"
    sd = {(k[len("features."):] if k.startswith("features.") else k): v
          for k, v in sd.items()}
    np.savez(args.out, **convert_state_dict(sd))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
