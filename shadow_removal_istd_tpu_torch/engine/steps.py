"""Train, eval and inference steps; port of
``shadow_removal_istd_tpu/engine/steps.py``.

:func:`train_step` reproduces ``_unjitted_train_step``:

1. one G forward in train mode (G1, then G2 on ``cat(x, m_pred)``),
   whose autograd graph serves the G phase: no second G forward; G1/G2
   BatchNorm statistics move once;
2. D phase on the DETACHED predictions: four train-mode D forwards in
   the order D1(x,m), D1(x,m_pred), D2(x,m,y), D2(x,m_pred,y_pred), the
   D running statistics moving in that order;
3. ``d_total = l2*D1 + l3*D2`` and the D Adam update;
4. G phase against the UPDATED D: four more train-mode D forwards (their
   statistics continue from step 2; D takes no update and no gradient
   here), ``g_total = data1 + l1*data2 + l2*G1 + l3*G2 + l4*vis1 +
   l5*vis2``, backward through the graph of step 1;
5. the G Adam update.

BEGAN (``net_d="began"``) swaps the adversarial terms for L1
reconstructions: D's ``real - k * fake`` per D, G's reconstruction of
its fake against the DETACHED prediction, and after the G update
``k <- clip(k + 0.001 * (0.7 * L_real - L_fake), 0, 1)`` from the D
phase's losses. SoftAdapt (``cfg.softadapt``) combines the (adversarial,
data, visual) groups with its detached weights in place of the lambdas,
then updates the weights from the groups.

The visual terms are gated per lambda: a zero lambda costs no VGG pass.
Metrics are detached 0-d tensors on the step's device; nothing here
waits for the device (k1, k2 and the SoftAdapt state stay there too).

``cfg.remat`` rematerializes the JAX step's three ``jax.checkpoint``
regions: the G forward (step 1), the D phase's forwards and loss (step
2) and the G phase's forwards and loss (step 4) keep only their inputs
across the backward, which replays them (``torch.utils.checkpoint``,
non-reentrant). A replay leaves the BatchNorm running statistics alone
(``models.layers.replaying_forward``) and draws the first call's dropout
masks from generators set back for it, so the step computes the plain
step's numbers, bit for bit on deterministic kernels. Unlike JAX, the
targets' VGG features are computed once, before the G phase, and kept
across the backward (2 x (B, 512, H/16, W/16) f32) rather than
recomputed. BEGAN's k and SoftAdapt's state update from the first
calls' values, once.

With ``state.mesh`` (a ``parallel.mesh.Mesh`` of more than one rank)
the batch is this rank's slice of the global batch, and the step
computes what one device computes on the global batch: it runs inside
``parallel.mesh.data_parallel`` (global BatchNorm statistics, dropout
masks and relativistic means), backpropagates each loss divided by the
world size and sums the gradients over the ranks before each Adam
update. The metrics, and BEGAN's and SoftAdapt's loss statistics, are
averaged over the ranks, so every rank returns the same metrics and
holds the same k1/k2 and SoftAdapt state. ``eval_step(mesh=...)`` does
the same for a sharded validation batch.

The mesh's other axes (``parallel.mesh``): on a model axis the train
step runs inside ``parallel.tensor.tensor_parallel`` (the modules hold
channel shards and compute column-parallel), backpropagates loss /
``n_data``, sums gradients over the data axis and broadcasts the
replicated layers' gradients over the model axis. Forward steps run
through :func:`forward_parallel`: row slabs of a spatial axis inside
``parallel.spatial.spatial_parallel``, column-parallel layers on a model
axis, and on the composed mesh every weight gathered to full at use
(``gather_model_leaves``, ZeRO-3) before the spatial forward, as the
JAX package does there. Their metrics average over the data x spatial
plane.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from shadow_removal_istd_tpu_torch.engine.state import (
    TrainState,
    set_learning_rates,
)
from shadow_removal_istd_tpu_torch.losses import (
    began_d_loss,
    began_k_update,
    l1_loss,
    softadapt_combine,
    softadapt_update,
    visual_loss,
)
from shadow_removal_istd_tpu_torch.losses.visual import (
    target_features,
    visual_loss_to,
)
from shadow_removal_istd_tpu_torch.models.layers import (
    replaying,
    replaying_forward,
)
from shadow_removal_istd_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    all_reduce_grads,
    data_parallel,
    gather_model_leaves,
    mean_across,
)
from shadow_removal_istd_tpu_torch.parallel.spatial import (
    is_sharded,
    spatial_parallel,
    split_rows,
)
from shadow_removal_istd_tpu_torch.parallel.tensor import (
    sync_replicated_grads,
    tensor_parallel,
)
from shadow_removal_istd_tpu_torch.utils.profiling import span

METRIC_KEYS = ("G", "G1", "G2", "D", "D1", "D2", "data1", "data2",
               "vis1", "vis2", "D1_real", "D1_fake", "D2_real", "D2_fake")


@contextlib.contextmanager
def forward_parallel(mesh: Mesh | None, nets):
    """The context of a forward step of ``nets`` over ``mesh``: on the
    composed mesh (spatial and model axes) every weight gathered to full
    then row slabs; else column-parallel layers on a model axis and row
    slabs on a spatial one. Row slabs are the tensors
    ``parallel.mesh.shard_images`` split; others run whole."""
    if mesh is None or mesh.world == 1:
        yield
        return
    with contextlib.ExitStack() as stack:
        if mesh.n_model > 1 and mesh.n_spatial > 1:
            stack.enter_context(gather_model_leaves(mesh, nets))
        else:
            stack.enter_context(tensor_parallel(mesh))
        stack.enter_context(spatial_parallel(mesh))
        yield


def _slabs(like: torch.Tensor, *outs: torch.Tensor) -> tuple:
    """``outs`` as row slabs when ``like`` is one (an output computed
    whole is split), else as they are."""
    if not is_sharded(like):
        return outs
    return tuple(t if is_sharded(t) else split_rows(t) for t in outs)


def infer_step(g1: nn.Module, g2: nn.Module, x: torch.Tensor,
               mesh: Mesh | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``m = G1(x)``, then ``y = G2(cat(x, m))``, both in eval mode.

    ``x`` is an (N, 3, H, W) image in [-1, 1]; it is cast to the matte's
    dtype before the concat, as the JAX serving engine does. Over
    ``mesh`` (the run's, see :func:`forward_parallel`) every rank calls
    it with its block of the batch; a row slab of ``x`` returns row
    slabs."""
    with forward_parallel(mesh, (g1, g2)):
        m = g1(x)
        y = g2(torch.cat([x.to(m.dtype), m], dim=1))
        return _slabs(x, m, y)


def _cat(*tensors: torch.Tensor) -> torch.Tensor:
    """Channel concat with the JAX type promotion (f32 with bf16 -> f32)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in tensors], dim=1)


def _vis_fns(state: TrainState, targets=None):
    """(vis1, vis2): the visual loss where its lambda is nonzero and a
    VGG is present, else a zero. With ``targets`` (m, y), each target's
    VGG features are computed here, once, and the loss runs against
    them: the remat step keeps them across its backward instead of
    recomputing them."""
    cfg = state.cfg

    def make(lam, target):
        if not (cfg.use_visual_loss and state.vgg is not None and lam != 0):
            return lambda pred, target: torch.zeros((), device=pred.device)
        if target is None:
            return lambda pred, target: visual_loss(state.vgg, pred, target)
        f_target = target_features(state.vgg, target)
        return lambda pred, _: visual_loss_to(state.vgg, pred, f_target)

    m, y = targets if targets is not None else (None, None)
    return make(cfg.lambda4, m), make(cfg.lambda5, y)


@contextlib.contextmanager
def _no_param_grads(*nets: nn.Module):
    params = [p for n in nets for p in n.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def _direct(fn: Callable, *args, gens=()):
    return fn(*args)


def _rematerialized(fn: Callable, *args, gens=()):
    """``fn(*args)`` keeping only its inputs for the backward, which
    replays ``fn`` (``torch.utils.checkpoint``, non-reentrant) where it
    needs the activations. The replay runs inside
    :func:`replaying_forward`, so BatchNorm statistics move once, and
    with each dropout generator in ``gens`` set back to its state before
    the first call, so it draws the first call's masks; each generator
    leaves the replay in the state it entered it."""
    gens = [g for g in gens if g is not None]
    before = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def replay():
        after = [g.get_state() for g in gens]
        for g, st in zip(gens, before):
            g.set_state(st)
        try:
            with replaying_forward():
                yield
        finally:
            for g, st in zip(gens, after):
                g.set_state(st)

    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          replay()))


def _no_mark(name: str) -> None:
    pass


def _backward(loss: torch.Tensor, nets, mesh: Mesh | None) -> None:
    """``loss.backward()``; over a mesh, of this rank's share of the
    global loss (``loss / n_data``), then the gradients of ``nets``'
    parameters summed over the data ranks, and those of the layers no
    model rank splits broadcast over the model ranks."""
    if mesh is None:
        loss.backward()
        return
    (loss / mesh.n_data).backward()
    all_reduce_grads([p for n in nets for p in n.parameters()], mesh)
    sync_replicated_grads(nets, mesh)


def _across(mesh: Mesh | None, tensors: list, key: str = "data") -> list:
    """Each tensor's mean over the ranks of the group ``key`` (see
    ``parallel.mesh.mean_across``), in one all-reduce; as they are for
    one rank."""
    if mesh is None or not tensors:
        return tensors
    flat = mean_across(torch.cat([t.detach().float().reshape(-1)
                                  for t in tensors]), mesh, key)
    out, ofs = [], 0
    for t in tensors:
        out.append(flat[ofs:ofs + t.numel()].reshape(t.shape).to(t.dtype))
        ofs += t.numel()
    return out


def train_step(state: TrainState, batch, gens=(None, None),
               mark: Callable[[str], None] = _no_mark
               ) -> dict[str, torch.Tensor]:
    """One adversarial step on ``batch = (x, m, y)`` (NCHW, [-1, 1]);
    ``gens`` are the G1 and G2 dropout generators. Updates ``state`` in
    place and returns the 14 metrics. ``mark(phase)`` is called as each
    phase's work has been enqueued ("g_forward", "d_phase", "g_adv",
    "g_visual", "g_backward", "adam_g"): a profiler records a CUDA event
    there to split the step's device time. Under ``cfg.remat`` the
    backward replays the G forward, the D phase's loss and the G phase's
    loss (the JAX step's three ``jax.checkpoint`` regions), so the
    D-phase and G-backward marks also hold those replays, and "g_adv"
    the targets' VGG forwards. Over ``state.mesh``, ``batch`` is this
    rank's slice of the global batch and the metrics are the global
    batch's; on a model axis the layers compute column-parallel.

    While tracing is on (``utils/profiling.py``) the step records device
    spans: ``train.step`` over ``step.g_forward``, ``step.d_phase``,
    ``step.g_phase`` (``step.visual`` around the visual losses, not in
    remat's replays), ``step.g_backward`` (``step.visual_backward`` over
    each VGG backward, ``losses/visual.py``) and ``step.adam_g``."""
    with data_parallel(state.mesh), tensor_parallel(state.mesh), \
            span("train.step", device=True):
        return _train_step(state, batch, gens, mark)


def _train_step(state: TrainState, batch, gens, mark):
    cfg, nets, adv = state.cfg, state.models, state.adv
    mesh = active_mesh()        # None for one rank
    g1, g2, d1, d2 = nets.all()
    x, m, y = batch
    for net in nets.all():
        net.train()
    set_learning_rates(state)
    region = _rematerialized if cfg.remat else _direct

    # ---- G forward, once
    def g_forward(x):
        m_pred = g1(x, generator=gens[0])
        y_pred = g2(_cat(x, m_pred), generator=gens[1])
        return m_pred, y_pred

    with span("step.g_forward", device=True):
        m_pred, y_pred = region(g_forward, x, gens=gens)
        m_sg, y_sg = m_pred.detach(), y_pred.detach()
    mark("g_forward")

    # ---- D phase on the detached predictions
    k1, k2, softadapt = state.k1, state.k2, state.softadapt

    def d_phase(x, m, y, m_sg, y_sg):
        c1_real = d1(_cat(x, m))
        c1_fake = d1(_cat(x, m_sg))
        c2_real = d2(_cat(x, m, y))
        c2_fake = d2(_cat(x, m_sg, y_sg))
        began = None
        if cfg.began:
            began = (l1_loss(c1_real, m), l1_loss(c1_fake, m_sg),
                     l1_loss(c2_real, y), l1_loss(c2_fake, y_sg))
            d1_l = began_d_loss(k1, began[0], began[1])
            d2_l = began_d_loss(k2, began[2], began[3])
        else:
            d1_l = adv.d_loss(c1_real, c1_fake)
            d2_l = adv.d_loss(c2_real, c2_fake)
        d_total = cfg.lambda2 * d1_l + cfg.lambda3 * d2_l
        return d_total, d1_l, d2_l, (c1_real, c1_fake, c2_real,
                                     c2_fake), began

    with span("step.d_phase", device=True):
        d_total, d1_l, d2_l, critics, began = region(d_phase, x, m, y, m_sg,
                                                     y_sg)
        state.opt_d.zero_grad(set_to_none=True)
        _backward(d_total, (d1, d2), mesh)
        state.opt_d.step()
    mark("d_phase")

    # ---- G phase against the updated D
    def g_phase(m_pred, y_pred):
        g_c1_real = d1(_cat(x, m))
        g_c1_fake = d1(_cat(x, m_pred))
        g_c2_real = d2(_cat(x, m, y))
        g_c2_fake = d2(_cat(x, m_pred, y_pred))
        if cfg.began:
            g1_l = l1_loss(g_c1_fake, m_sg)
            g2_l = l1_loss(g_c2_fake, y_sg)
        else:
            g1_l = adv.g_loss(g_c1_real, g_c1_fake)
            g2_l = adv.g_loss(g_c2_real, g_c2_fake)
        data1 = l1_loss(m_pred, m)
        data2 = l1_loss(y_pred, y)
        replay = replaying()
        if not replay:
            mark("g_adv")
        with (contextlib.nullcontext() if replay
              else span("step.visual", device=True)):
            vis1 = vis1_fn(m_pred, m)
            vis2 = vis2_fn(y_pred, y)
        if not replay:
            mark("g_visual")
        groups = None
        if cfg.softadapt:
            # the lambdas live in the weights ([1, l1, l2] at init), not
            # in the groups, so they are not applied twice
            groups = torch.stack([(g1_l + g2_l).float(),
                                  (data1 + data2).float(),
                                  (vis1 + vis2).float()])
            g_total = softadapt_combine(softadapt, groups)
        else:
            g_total = (data1 + cfg.lambda1 * data2
                       + cfg.lambda2 * g1_l + cfg.lambda3 * g2_l
                       + cfg.lambda4 * vis1 + cfg.lambda5 * vis2)
        return g_total, (g1_l, g2_l, data1, data2, vis1, vis2), groups

    # the replays of g_phase and g_forward run inside g_total.backward(),
    # so under the same frozen D as the first calls
    with _no_param_grads(d1, d2):
        with span("step.g_phase", device=True):
            vis1_fn, vis2_fn = _vis_fns(state, (m, y) if cfg.remat else None)
            g_total, terms, groups = region(g_phase, m_pred, y_pred)
        with span("step.g_backward", device=True):
            state.opt_g.zero_grad(set_to_none=True)
            _backward(g_total, (g1, g2), mesh)
        mark("g_backward")
    with span("step.adam_g", device=True):
        state.opt_g.step()
    mark("adam_g")
    state.step += 1
    g1_l, g2_l, data1, data2, vis1, vis2 = terms
    c1_real, c1_fake, c2_real, c2_fake = critics
    out = {"G": g_total, "G1": g1_l, "G2": g2_l, "D": d_total, "D1": d1_l,
           "D2": d2_l, "data1": data1, "data2": data2, "vis1": vis1,
           "vis2": vis2, "D1_real": c1_real.mean(), "D1_fake": c1_fake.mean(),
           "D2_real": c2_real.mean(), "D2_fake": c2_fake.mean()}
    metrics = [v.detach().float() for v in out.values()]
    extra = [*(began or ()), *(() if groups is None else (groups,))]
    reduced = _across(mesh, metrics + list(extra))
    metrics, extra = reduced[:len(metrics)], reduced[len(metrics):]
    with torch.no_grad():
        if cfg.began:
            state.k1 = began_k_update(state.k1, extra[0], extra[1])
            state.k2 = began_k_update(state.k2, extra[2], extra[3])
        if cfg.softadapt:
            state.softadapt = softadapt_update(state.softadapt, extra[-1])
    return dict(zip(out, metrics))


@torch.no_grad()
def eval_step(state: TrainState, batch, return_preds: bool = False,
              mesh: Mesh | None = None):
    """Validation: eval-mode forwards (the generators' decoder steps go
    through the decoder op), no updates, the train step's losses plus
    the model-selection proxy ``total = 0.8*G + 0.2*D``; the fixed
    lambdas weigh G even under SoftAdapt, as in the JAX package. With
    ``return_preds``, returns ``(metrics, (m_pred, y_pred))``: the
    evaluation protocol scores these without a second G forward. With
    ``mesh``, ``batch`` is this rank's block of a global batch (its data
    rows, and its row slabs on a spatial axis, ``shard_images``) and the
    metrics (relativistic means included) are the global batch's,
    averaged over the data x spatial plane; the predictions are the
    rank's block. The layers' parallel forms follow ``state.mesh``
    (:func:`forward_parallel`)."""
    nets = state.models.all()
    with data_parallel(mesh), forward_parallel(state.mesh, nets):
        metrics, preds = _eval_step(state, batch)
        preds = _slabs(batch[0], *preds)
        metrics = dict(zip(metrics, _across(active_mesh(),
                                            list(metrics.values()),
                                            "forward")))
    return (metrics, preds) if return_preds else metrics


def _eval_step(state: TrainState, batch):
    cfg, nets, adv = state.cfg, state.models, state.adv
    g1, g2, d1, d2 = nets.all()
    x, m, y = batch
    for net in nets.all():
        net.eval()
    vis1_fn, vis2_fn = _vis_fns(state)
    m_pred = g1(x)
    y_pred = g2(_cat(x, m_pred))
    c1_real = d1(_cat(x, m))
    c1_fake = d1(_cat(x, m_pred))
    c2_real = d2(_cat(x, m, y))
    c2_fake = d2(_cat(x, m_pred, y_pred))
    if cfg.began:
        g1_l = l1_loss(c1_fake, m_pred)
        g2_l = l1_loss(c2_fake, y_pred)
        d1_l = began_d_loss(state.k1, l1_loss(c1_real, m), g1_l)
        d2_l = began_d_loss(state.k2, l1_loss(c2_real, y), g2_l)
    else:
        d1_l = adv.d_loss(c1_real, c1_fake)
        d2_l = adv.d_loss(c2_real, c2_fake)
        g1_l = adv.g_loss(c1_real, c1_fake)
        g2_l = adv.g_loss(c2_real, c2_fake)
    data1 = l1_loss(m_pred, m)
    data2 = l1_loss(y_pred, y)
    vis1 = vis1_fn(m_pred, m)
    vis2 = vis2_fn(y_pred, y)
    g_total = (data1 + cfg.lambda1 * data2 + cfg.lambda2 * g1_l
               + cfg.lambda3 * g2_l + cfg.lambda4 * vis1
               + cfg.lambda5 * vis2)
    d_total = cfg.lambda2 * d1_l + cfg.lambda3 * d2_l
    out = {"G": g_total, "G1": g1_l, "G2": g2_l, "D": d_total, "D1": d1_l,
           "D2": d2_l, "data1": data1, "data2": data2, "vis1": vis1,
           "vis2": vis2, "total": 0.8 * g_total + 0.2 * d_total,
           "D1_real": c1_real.mean(), "D1_fake": c1_fake.mean(),
           "D2_real": c2_real.mean(), "D2_fake": c2_fake.mean()}
    return {k: v.float() for k, v in out.items()}, (m_pred, y_pred)
