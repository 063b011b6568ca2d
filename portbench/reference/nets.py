"""The networks of ST-CGAN in plain PyTorch, as functions of a weight map.

- MNet (the reference's ``src/networks.py`` generator, depth 4): a 4x4
  stride-2 reflect-padded conv stem; four blocks LeakyReLU(0.2) -> 4x4
  stride-2 reflect conv -> BatchNorm, channels 2, 4, 8, 8 x ngf, each
  keeping its post-LeakyReLU input as the skip link; four decoder steps
  LeakyReLU -> 2x upsample -> BatchNorm, then the link concatenated
  (Dropout2d on all but the outermost in training); a final upsample
  without LeakyReLU or BatchNorm to the output channels, then tanh. The
  upsample is nearest 2x then a 3x3 reflect conv (served), or a
  ConvTranspose(4, 2, 1) whose kernel is applied unflipped, as flax
  applies it (trained).
- PatchGAN: a 4x4 stride-2 zero-padded conv with bias, LeakyReLU; two
  4x4 stride-2 reflect convs doubling the channels, then a 3x3 reflect
  conv doubling them, each followed by LeakyReLU then BatchNorm; a 3x3
  reflect conv to one logit map.
- The pix2pix U-Net (8 downs) and the 70x70 NLayer discriminator, as in
  Isola et al.'s code (the reference's ``STCGAN/`` tree).
- VGG-19-BN ``features[:40]`` (through pool4), frozen, eval BatchNorm.

BatchNorm: eps 1e-5; in training the batch mean and biased variance;
in eval the running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


# -- weight maps ----------------------------------------------------------

def _bn(prefix, c):
    return [(f"{prefix}.weight", (c,), "bn_weight"),
            (f"{prefix}.bias", (c,), "bn_bias"),
            (f"{prefix}.running_mean", (c,), "mean"),
            (f"{prefix}.running_var", (c,), "var")]


def mnet_leaves(cin, cout, ngf, nearest: bool):
    """(name, shape, kind) of every MNet weight."""
    k = 3 if nearest else 4
    feats = [2 * ngf, 4 * ngf, 8 * ngf, 8 * ngf]
    cins = [ngf, 2 * ngf, 4 * ngf, 8 * ngf]
    up_feats = [ngf, 2 * ngf, 4 * ngf, 8 * ngf]
    out = [("stem.weight", (ngf, cin, 4, 4), "conv")]
    for i in range(4):
        out.append((f"downs.{i}.conv.weight", (feats[i], cins[i], 4, 4), "conv"))
        out += _bn(f"downs.{i}.bn", feats[i])
    for j, i in enumerate((3, 2, 1, 0)):
        ci = feats[-1] if i == 3 else 2 * up_feats[i + 1]
        out.append((f"ups.{j}.up.weight", (up_feats[i], ci, k, k), "conv"))
        out += _bn(f"ups.{j}.bn", up_feats[i])
    out.append(("final.weight", (cout, 2 * ngf, k, k), "conv"))
    return out


def patchgan_leaves(cin, ndf):
    out = [("stem.weight", (ndf, cin, 4, 4), "conv"), ("stem.bias", (ndf,), "bias")]
    chans = [(ndf, 2 * ndf, 4), (2 * ndf, 4 * ndf, 4), (4 * ndf, 8 * ndf, 3)]
    for k, (a, b, ks) in enumerate(chans):
        out.append((f"convs.{k}.weight", (b, a, ks, ks), "conv"))
        out += _bn(f"norms.{k}.bn", b)
    out.append(("final.weight", (1, 8 * ndf, 3, 3), "conv"))
    return out


def pix2pix_leaves(cin, cout, ngf, num_downs=8):
    inner = [ngf, 2 * ngf, 4 * ngf] + [8 * ngf] * (num_downs - 3)
    out = []
    for lv in range(num_downs):
        c0 = cin if lv == 0 else inner[lv - 1]
        out.append((f"downs.{lv}.weight", (inner[lv], c0, 4, 4), "conv"))
    for lv in range(1, num_downs - 1):
        out += _bn(f"down_bns.{lv - 1}", inner[lv])
    for lv in range(num_downs):
        ci = inner[lv] if lv == num_downs - 1 else 2 * inner[lv]
        co = cout if lv == 0 else inner[lv - 1]
        out.append((f"ups.{lv}.weight", (co, ci, 4, 4), "conv"))
    out.append(("ups.0.bias", (cout,), "bias"))
    for lv in range(1, num_downs):
        out += _bn(f"up_bns.{lv - 1}", inner[lv - 1])
    return out


def nlayer_leaves(cin, ndf, n_layers=3):
    mults = [min(2 ** n, 8) for n in range(n_layers + 1)]
    out = [("convs.0.weight", (ndf, cin, 4, 4), "conv"), ("convs.0.bias", (ndf,), "bias")]
    for n in range(1, n_layers + 1):
        out.append((f"convs.{n}.weight", (ndf * mults[n], ndf * mults[n - 1], 4, 4), "conv"))
        out += _bn(f"bns.{n - 1}", ndf * mults[n])
    last = n_layers + 1
    out.append((f"convs.{last}.weight", (1, ndf * mults[n_layers], 4, 4), "conv"))
    out.append((f"convs.{last}.bias", (1,), "bias"))
    return out


VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_leaves():
    out, cin = [], 3
    for idx, spec in enumerate(VGG_CFG):
        if spec == "M":
            continue
        p = f"layers.{idx}"
        out += [(f"{p}.weight", (spec, cin, 3, 3), "conv_relu"),
                (f"{p}.bias", (spec,), "bias"),
                (f"{p}.bn_weight", (spec,), "bn_weight"),
                (f"{p}.bn_bias", (spec,), "bn_bias"),
                (f"{p}.running_mean", (spec,), "mean"),
                (f"{p}.running_var", (spec,), "var")]
        cin = spec
    return out


def trainable(name: str) -> bool:
    """Parameters train; BatchNorm running statistics are buffers."""
    return not name.endswith(("running_mean", "running_var"))


# -- layers -----------------------------------------------------------------

def leaky(x):
    return F.leaky_relu(x, 0.2)


def reflect_conv(x, w, stride, pad):
    return F.conv2d(F.pad(x, (pad,) * 4, mode="reflect"), w, stride=stride)


def conv_transpose_unflipped(x, w, b=None):
    """flax ConvTranspose(4, stride 2, 'SAME') with the (Co, Ci, 4, 4)
    kernel applied unflipped."""
    return F.conv_transpose2d(x, w.transpose(0, 1).flip(2, 3), b, stride=2,
                              padding=1)


def nearest2x(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


def bn(x, p, prefix, train: bool):
    w, b = p[f"{prefix}.weight"], p[f"{prefix}.bias"]
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
    shape = (1, -1, 1, 1)
    return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + EPS) \
        * w.view(shape) + b.view(shape)


def dropout2d(x, rate, gen):
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=gen,
                      device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


# -- networks -------------------------------------------------------------

def mnet(p, x, *, train: bool, nearest: bool, droprate=0.0, gen=None):
    y = reflect_conv(x, p["stem.weight"], 2, 1)
    links = []
    for i in range(4):
        a = leaky(y)
        links.append(a)
        y = bn(reflect_conv(a, p[f"downs.{i}.conv.weight"], 2, 1), p,
               f"downs.{i}.bn", train)
    for j in range(4):
        w = p[f"ups.{j}.up.weight"]
        a = leaky(y)
        u = (reflect_conv(nearest2x(a), w, 1, 1) if nearest
             else conv_transpose_unflipped(a, w))
        y = torch.cat([bn(u, p, f"ups.{j}.bn", train), links[3 - j]], 1)
        if train and droprate > 0 and j < 3:
            y = dropout2d(y, droprate, gen)
    w = p["final.weight"]
    y = (reflect_conv(nearest2x(y), w, 1, 1) if nearest
         else conv_transpose_unflipped(y, w))
    return torch.tanh(y)


def patchgan(p, x):
    y = leaky(F.conv2d(x, p["stem.weight"], p["stem.bias"], stride=2, padding=1))
    for k, (stride, pad) in enumerate(((2, 1), (2, 1), (1, 1))):
        y = bn(leaky(reflect_conv(y, p[f"convs.{k}.weight"], stride, pad)), p,
               f"norms.{k}.bn", True)
    return reflect_conv(y, p["final.weight"], 1, 1)


def pix2pix(p, x, num_downs=8):
    def block(x, lv):
        if x.shape[2] % 2 or x.shape[3] % 2:
            raise ValueError(f"level {lv} of the U-Net gets an odd size {tuple(x.shape[2:])}")
        outermost, innermost = lv == 0, lv == num_downs - 1
        y = x if outermost else leaky(x)
        y = F.conv2d(y, p[f"downs.{lv}.weight"], stride=2, padding=1)
        if not outermost and not innermost:
            y = bn(y, p, f"down_bns.{lv - 1}", True)
        if not innermost:
            y = block(y, lv + 1)
        y = F.conv_transpose2d(F.relu(y), p[f"ups.{lv}.weight"].transpose(0, 1).flip(2, 3),
                               p.get(f"ups.{lv}.bias"), stride=2, padding=1)
        if outermost:
            return torch.tanh(y)
        # the reference's in-place LeakyReLU has changed x before the concat
        return torch.cat([leaky(x), bn(y, p, f"up_bns.{lv - 1}", True)], 1)

    return block(x, 0)


def nlayer(p, x, n_layers=3):
    y = leaky(F.conv2d(x, p["convs.0.weight"], p["convs.0.bias"], stride=2, padding=1))
    for n in range(1, n_layers + 1):
        y = F.conv2d(y, p[f"convs.{n}.weight"], stride=2 if n < n_layers else 1,
                     padding=1)
        y = leaky(bn(y, p, f"bns.{n - 1}", True))
    last = n_layers + 1
    return F.conv2d(y, p[f"convs.{last}.weight"], p[f"convs.{last}.bias"], padding=1)


def vgg(p, x):
    for idx, spec in enumerate(VGG_CFG):
        if spec == "M":
            x = F.max_pool2d(x, 2)
            continue
        q = f"layers.{idx}"
        y = F.conv2d(x, p[f"{q}.weight"], p[f"{q}.bias"], padding=1)
        y = (y - p[f"{q}.running_mean"].view(1, -1, 1, 1)) \
            / torch.sqrt(p[f"{q}.running_var"].view(1, -1, 1, 1) + EPS) \
            * p[f"{q}.bn_weight"].view(1, -1, 1, 1) + p[f"{q}.bn_bias"].view(1, -1, 1, 1)
        x = F.relu(y)
    return x


def vgg_features(p, img_pm1):
    """[-1, 1] images (a matte broadcast to 3 channels) -> ImageNet
    normalisation -> VGG features."""
    img = img_pm1 * 0.5 + 0.5
    if img.shape[1] == 1:
        img = img.expand(-1, 3, -1, -1)
    mean = torch.tensor(IMAGENET_MEAN, device=img.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=img.device).view(1, 3, 1, 1)
    return vgg(p, (img - mean) / std)
