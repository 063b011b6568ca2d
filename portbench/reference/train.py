"""One adversarial ST-CGAN step and Adam, from their definitions.

The step (Wang et al., CVPR 2018, as the reference trainer orders it):

1. G forward in training mode: ``m' = G1(x)``, ``y' = G2(x ++ m')``;
2. D phase on the detached predictions, in the order D1(x, m),
   D1(x, m'), D2(x, m, y), D2(x, m', y'); each D loss is the mean of its
   real and fake terms; ``d = l2 * D1 + l3 * D2``; Adam on D1 and D2;
3. G phase against the updated D: the same four D forwards, the G terms
   on the fakes; ``g = L1(m', m) + l1 * L1(y', y) + l2 * G1 + l3 * G2 +
   l4 * vis(m', m) + l5 * vis(y', y)``, ``vis`` the mean squared error of
   VGG-19-BN features (target branch without gradient); Adam on G1, G2.

The adversarial terms are the reference engine's as it runs them for
``--D-loss-fn standard --D-type normal``: the mean squared error against
labels 1 (real) and 0 (fake). Adam: torch's defaults but the betas and
epsilon of the configuration; the rate ``lr * (1 - decay) ** (step //
steps_per_epoch)``.
"""

from __future__ import annotations

import torch

from portbench.reference import nets

METRICS = ("G", "G1", "G2", "D", "D1", "D2", "data1", "data2", "vis1",
           "vis2", "D1_real", "D1_fake", "D2_real", "D2_fake")


class Adam:
    def __init__(self, params, beta1, beta2, eps):
        self.params, self.b1, self.b2, self.eps = params, beta1, beta2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / c2 ** 0.5 + self.eps
            p.sub_(lr / c1 * self.m[k] / denom)


def _mse(x, label):
    return (x - label).square().mean()


def _l1(a, b):
    return (a - b).abs().mean()


class Trainer:
    """The four networks' weights (``nets`` name maps), the VGG's, and
    both Adam states, for ``cfg`` (the configuration's ``train`` dict)."""

    def __init__(self, cfg, weights: dict, vgg: dict | None):
        if (cfg["d_loss_fn"], cfg["d_type"], cfg["loss_mode"]) != ("standard", "normal",
                                                                   "reference"):
            raise ValueError("the reference step implements D-loss 'standard', "
                             "type 'normal', as the reference engine runs them")
        self.cfg = cfg
        self.w = {}
        self.trainable = {}
        for net, leaves in weights.items():
            self.w[net] = {k: v.detach().clone() for k, v in leaves.items()}
            self.trainable[net] = {k: v for k, v in self.w[net].items() if nets.trainable(k)}
        g_params = {f"{n}.{k}": v for n in ("g1", "g2") for k, v in self.trainable[n].items()}
        d_params = {f"{n}.{k}": v for n in ("d1", "d2") for k, v in self.trainable[n].items()}
        self.opt_g = Adam(g_params, cfg["beta1"], cfg["beta2"], cfg["adam_eps"])
        self.opt_d = Adam(d_params, cfg["beta1"], cfg["beta2"], cfg["adam_eps"])
        self.vgg = vgg
        self.steps = 0

    def lr(self, base):
        return base * (1.0 - self.cfg["decay"]) ** (self.steps // self.cfg["steps_per_epoch"])

    def _g(self, which, p, x, gen):
        c = self.cfg
        if c["net_g"] == "mnet":
            return nets.mnet(p, x, train=True, nearest=c["nn_upconv"],
                             droprate=c["droprate"], gen=gen)
        return nets.pix2pix(p, x)

    def _d(self, p, x):
        return nets.patchgan(p, x) if self.cfg["net_d"] == "patchgan" else nets.nlayer(p, x)

    def _vis(self, pred, target):
        with torch.no_grad():
            f_t = nets.vgg_features(self.vgg, target)
        return (nets.vgg_features(self.vgg, pred) - f_t).square().mean()

    def step(self, batch, gens):
        """One step on ``(x, m, y)``; returns the 14 metrics (floats) and
        the gradients each Adam received (name -> tensor)."""
        c = self.cfg
        x, m, y = batch
        params = {n: {k: v.requires_grad_(nets.trainable(k)) for k, v in self.w[n].items()}
                  for n in self.w}
        m_p = self._g("g1", params["g1"], x, gens[0])
        y_p = self._g("g2", params["g2"], torch.cat([x, m_p], 1), gens[1])
        ms, ys = m_p.detach(), y_p.detach()
        c1r = self._d(params["d1"], torch.cat([x, m], 1))
        c1f = self._d(params["d1"], torch.cat([x, ms], 1))
        c2r = self._d(params["d2"], torch.cat([x, m, y], 1))
        c2f = self._d(params["d2"], torch.cat([x, ms, ys], 1))
        d1 = (_mse(c1r, 1.0) + _mse(c1f, 0.0)) * 0.5
        d2 = (_mse(c2r, 1.0) + _mse(c2f, 0.0)) * 0.5
        d_total = c["lambda2"] * d1 + c["lambda3"] * d2
        keys = list(self.opt_d.params)
        grads = torch.autograd.grad(d_total, [self.opt_d.params[k] for k in keys],
                                    allow_unused=True)
        g_d = {k: (g if g is not None else torch.zeros_like(self.opt_d.params[k]))
               for k, g in zip(keys, grads)}
        self.opt_d.step(g_d, self.lr(c["lr_d"]))
        dp = {n: {k: v.detach() for k, v in self.w[n].items()} for n in ("d1", "d2")}
        g_c1f = self._d(dp["d1"], torch.cat([x, m_p], 1))
        g_c2f = self._d(dp["d2"], torch.cat([x, m_p, y_p], 1))
        g1 = _mse(g_c1f, 1.0)
        g2 = _mse(g_c2f, 1.0)
        data1, data2 = _l1(m_p, m), _l1(y_p, y)
        zero = torch.zeros((), device=x.device)
        vis1 = self._vis(m_p, m) if self.vgg is not None and c["lambda4"] else zero
        vis2 = self._vis(y_p, y) if self.vgg is not None and c["lambda5"] else zero
        g_total = (data1 + c["lambda1"] * data2 + c["lambda2"] * g1
                   + c["lambda3"] * g2 + c["lambda4"] * vis1 + c["lambda5"] * vis2)
        keys_g = list(self.opt_g.params)
        grads = torch.autograd.grad(g_total, [self.opt_g.params[k] for k in keys_g],
                                    allow_unused=True)
        g_g = {k: (g if g is not None else torch.zeros_like(self.opt_g.params[k]))
               for k, g in zip(keys_g, grads)}
        self.opt_g.step(g_g, self.lr(c["lr_g"]))
        for n in self.w:
            for v in self.w[n].values():
                v.requires_grad_(False)
        self.steps += 1
        vals = (g_total, g1, g2, d_total, d1, d2, data1, data2, vis1, vis2,
                c1r.mean(), c1f.mean(), c2r.mean(), c2f.mean())
        return dict(zip(METRICS, (float(v.detach()) for v in vals))), {**g_d, **g_g}

    def params(self):
        return {f"{n}.{k}": v for n in self.trainable for k, v in self.trainable[n].items()}
