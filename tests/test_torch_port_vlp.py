"""The port's vision-language pretraining path against the JAX package: the
CLIP losses (``vlp_tpu_torch/ops/losses.py``), ``VisionLanguageTask``
(``loss_fn`` in its three loss variants, its gradients and BatchNorm
statistics, one AdamW step, the ``_split_lr`` and ``_frozen_text``
parameter groups against ``optax.multi_transform``; ``eval_fn``,
``embed_images_fn`` and ``features_fn``), ``convert`` of the dual tower's
variables and AdamW moments, ``image_dropout`` dropped as the JAX registry
drops it, and ``train.setup``'s pretrain run. The task runs ``resnet_micro`` +
``microbert`` (the JAX package's test towers) at 32 px on 12-token
captions with duplicates, a padded row and a caption whose mask is all
zeros, fp32, augmentation off; weights and running statistics perturbed
after init and carried across by ``convert``.

Tolerances:
- the losses on the same fp32 embeddings: 1e-5 of the value, and of each
  gradient's largest |g| (the same fp32 arithmetic in other orders).
- the task's loss 1e-5 relative; gradients 1e-3 of each tensor's largest
  |g|, BatchNorm statistics 1e-5 (``test_torch_port_resnet.py``'s bounds:
  train-mode BatchNorm's backward cancels and magnifies summation-order
  differences), each compared as the port packs it except the attention's
  q|k|v kernel and bias, compared in their flax parts. The key bias has an
  exact gradient of 0 (softmax ignores a shift of a query's scores): on
  both sides it is rounding noise, held below 1e-6 of the largest |g| of
  the model.
- parameters after one AdamW step (one per group): where |g| > 1e-2 of the
  tensor's largest, the two sides step by the group's lr * sign(g) within
  two fp32 ulps plus 1e-5 * lr; elsewhere within 2 * lr
  (``test_torch_port_train_step.py`` gives the reasoning); a frozen
  group's parameters bit-equal to their start on both sides.
- eval mode (running statistics): 2e-5 of the largest |value|.
"""
import dataclasses
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vlp_tpu.config import get_experiment
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.ops import losses as jlosses
from vlp_tpu.ops.augment import AugmentConfig as JAugment
from vlp_tpu.train.optim import make_optimizer as jmake_optimizer
from vlp_tpu.train.state import TrainState as JState
from vlp_tpu.train.step import make_train_step as jmake_train_step
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import TRAIN_EXPERIMENTS, TrainConfig
from vlp_tpu_torch.models.registry import create_backbone
from vlp_tpu_torch.models.tasks import (TaskStatics, VisionLanguageTask,
                                        build_task)
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.ops import losses
from vlp_tpu_torch.train.optim import make_optimizer
from vlp_tpu_torch.train.setup import build_training, random_pretrain_batch
from vlp_tpu_torch.train.state import TrainState
from vlp_tpu_torch.train.step import make_train_step, to_device, train_steps

EXP = "pretrain_resnet34_tinybert"
B, SIZE, L, LR, SPE = 6, 32, 12, 1e-3, 2
MEAN, STD = 120.0, 50.0
LOSS_REL = 1e-5
GRAD_REL = 1e-3
SIGNIFICANT = 10 * GRAD_REL
EVAL_REL = 2e-5
CPU = torch.device("cpu")
# parameters whose exact gradient is 0
ZERO_GRAD = "attn.key.bias"


# --------------------------------------------------------------------------
# the CLIP losses
# --------------------------------------------------------------------------

def _embeddings(seed, n=7, e=16):
    """Two towers' embeddings, caption ids with duplicates, a padded last
    row."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, e)).astype(np.float32)
    txt = rng.standard_normal((n, e)).astype(np.float32)
    cid = np.array([0, 1, 0, 2, 1, 3, 1], np.int32)[:n]
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    return img, txt, cid, mask


LOSSES = {
    "symmetric": (lambda lg, c, m: jlosses.symmetric_infonce(lg, m),
                  lambda lg, c, m: losses.symmetric_infonce(lg, m)),
    "symmetric_unmasked": (lambda lg, c, m: jlosses.symmetric_infonce(lg),
                           lambda lg, c, m: losses.symmetric_infonce(lg)),
    "masked": (jlosses.masked_infonce, losses.masked_infonce),
    "masked_unmasked": (lambda lg, c, m: jlosses.masked_infonce(lg, c),
                        lambda lg, c, m: losses.masked_infonce(lg, c)),
    "non_square": (jlosses.non_square_infonce, losses.non_square_infonce),
    "non_square_unmasked": (
        lambda lg, c, m: jlosses.non_square_infonce(lg, c),
        lambda lg, c, m: losses.non_square_infonce(lg, c)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("logit_scale", [0.3, float(np.log(100.0)) + 0.5])
def test_clip_losses_and_gradients_match_jax(name, logit_scale):
    """Values and gradients w.r.t. both towers and ``logit_scale``; above
    log(100) the scale is clamped and its gradient 0 on both sides."""
    jloss, tloss = LOSSES[name]
    img, txt, cid, mask = _embeddings(0)

    def jfn(i, t, s):
        return jloss(jlosses.clip_logits(i, t, s, 100.0), jnp.asarray(cid),
                     jnp.asarray(mask))

    want, want_g = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(txt), jnp.float32(logit_scale))
    ti, tt = torch.tensor(img, requires_grad=True), torch.tensor(
        txt, requires_grad=True)
    ts = torch.tensor(logit_scale, requires_grad=True)
    got = tloss(losses.clip_logits(ti, tt, ts, 100.0), torch.tensor(cid),
                torch.tensor(mask))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=LOSS_REL)
    for g, w in zip((ti.grad, tt.grad, ts.grad), want_g):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=LOSS_REL * max(
            np.abs(w).max(), 1e-6))
    if logit_scale > np.log(100.0):
        assert ts.grad.item() == 0.0


def test_clip_logits_normalisation_and_duplicate_mask_match_jax():
    """A zero row stays zero (the normalisation's eps); its gradient is 0
    here and NaN in JAX (``jnp.linalg.norm``'s at 0), which no trained
    embedding reaches."""
    img, txt, cid, _ = _embeddings(1)
    img[2] = 0.0
    np.testing.assert_allclose(
        losses.l2_normalize(torch.tensor(img)).numpy(),
        np.asarray(jlosses.l2_normalize(jnp.asarray(img))), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_array_equal(
        losses.duplicate_caption_mask(torch.tensor(cid)).numpy(),
        np.asarray(jlosses.duplicate_caption_mask(jnp.asarray(cid))))
    logits = losses.clip_logits(torch.tensor(img), torch.tensor(txt),
                                torch.tensor(5.0), 100.0)
    assert logits.abs().max().item() <= 100.0 * (1 + 1e-6)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jlosses.clip_logits(
            jnp.asarray(img), jnp.asarray(txt), jnp.float32(5.0), 100.0)),
        rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the task
# --------------------------------------------------------------------------

def _cfg(name=EXP, **changes):
    """A pretrain experiment at a test size: resnet_micro + microbert,
    32 px, 12 tokens, fp32, augmentation off."""
    cfg = get_experiment(name)
    cfg.model.model = "resnet_micro"
    cfg.model.text_model = "microbert"
    cfg.trainer.precision = "fp32"
    cfg.data.image_size = SIZE
    cfg.data.max_token_length = L
    cfg.data.disable_augmentations = True
    for key, value in changes.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, value)
    return cfg


def _batch(seed):
    """A pretrain batch: every caption twice, row 4's caption mask all
    zeros, the last row padded (``mask`` 0)."""
    b = random_pretrain_batch(np.random.default_rng(seed), B, SIZE, L,
                              "microbert")
    b["attention_mask"][4] = 0
    b["mask"][-1] = 0.0
    return b


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    v = jax.device_get(variables)

    def noise(p, scale):
        return rng.standard_normal(p.shape).astype(np.float32) * scale

    out = {"params": jax.tree.map(lambda p: np.asarray(p) + noise(p, 0.05),
                                  v["params"])}
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, p: np.asarray(p) + (
            np.abs(noise(p, 0.5)) if path[-1].key == "var"
            else noise(p, 0.1)), v["batch_stats"])
    return out


def _tasks(cfg, seed=3):
    """(JAX task, perturbed variables, the port's task with them)."""
    jtask = jbuild_task(cfg, JStatics(mean=MEAN, std=STD,
                                      augment=JAugment(enabled=False)))
    variables = _perturbed(jtask.init_variables(
        jax.random.key(0), jax.tree.map(jnp.asarray, _batch(0))), seed)
    tcfg = TrainConfig.from_config(cfg)
    task = build_task(tcfg, TaskStatics(mean=MEAN, std=STD,
                                        augment=tcfg.augment()), CPU)
    assert isinstance(task, VisionLanguageTask)
    convert.load_weights(task.model, variables)
    return jtask, variables, task


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _stats_rel(model, batch_stats):
    sd = model.state_dict()
    flat = convert.flatten({"batch_stats": jax.device_get(batch_stats)})
    return max(_rel(sd[convert.torch_key(k)].numpy(), a)
               for k, a in flat.items())


def _params(model, tree):
    return convert.state_dict_from_flax({"params": jax.device_get(tree)},
                                        model, params_only=True)


_PACKED = re.compile(r"^(.*attn\.)qkv\.(weight|bias)$")


def _views(named):
    """{name: tensor or None} with each packed ``attn.qkv`` kernel and bias
    split into its flax parts, ``attn.{query,key,value}.*``."""
    out = {}
    for name, t in named.items():
        m = _PACKED.match(name)
        if m is None:
            out[name] = t
            continue
        chunks = (None,) * 3 if t is None else t.chunk(3, -1)
        for part, chunk in zip(("query", "key", "value"), chunks):
            out[f"{m[1]}{part}.{m[2]}"] = chunk
    return out


def _named(model, attr=None):
    """The model's parameters (or their ``attr``) as ``_views``."""
    return _views({n: p if attr is None else getattr(p, attr)
                   for n, p in model.named_parameters()})


@pytest.mark.parametrize("variant", ["symmetric_infonce", "masked",
                                     "non_square"])
def test_task_loss_gradients_and_batch_stats_match_jax(variant):
    cfg = _cfg(model__loss_variant=variant)
    jtask, variables, task = _tasks(cfg)
    assert task.loss_variant == variant
    batch = _batch(1)
    (jloss, (mutated, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jtask.loss_fn, has_aux=True))(
            variables["params"], {"batch_stats": variables["batch_stats"]},
            jax.tree.map(jnp.asarray, batch), jax.random.key(4))
    task.model.eval()  # loss_fn sets the training mode itself
    loss, aux = task.loss_fn(to_device(batch, CPU), torch.Generator())
    assert task.model.training
    loss.backward()
    assert set(aux) == {"loss", "logit_scale", "img_emb", "txt_emb", "mask"}
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_REL)
    assert aux["loss"].item() == pytest.approx(float(jaux["loss"]),
                                               rel=LOSS_REL)
    for key in ("img_emb", "txt_emb", "logit_scale"):
        assert _rel(aux[key].detach().numpy(), jaux[key]) <= 1e-4, key
    assert torch.isfinite(aux["txt_emb"][4]).all()  # all-zero caption mask
    want = _views(_params(task.model, jgrads))
    top = max(w.abs().max().item() for w in want.values())
    grads = _named(task.model, "grad")
    assert set(grads) == set(want)
    for name, g in grads.items():
        if name.endswith(ZERO_GRAD):
            assert max(g.abs().max().item(),
                       want[name].abs().max().item()) <= 1e-6 * top, name
            continue
        scale = want[name].abs().max().item()
        assert (g - want[name]).abs().max().item() <= GRAD_REL * scale, \
            name
    assert _stats_rel(task.model, mutated["batch_stats"]) <= 1e-5


def _one_step(cfg, seed):
    """One training step on both sides from the same weights; returns (the
    port's model, its gradients, the JAX parameters after the step, the
    port's optimizer and step aux, the starting parameters)."""
    jtask, variables, task = _tasks(cfg, seed=seed)
    params, extra = variables["params"], {
        "batch_stats": variables["batch_stats"]}
    tx = jmake_optimizer(cfg, params, SPE)
    jstate = JState.create(params, extra, tx, jax.random.key(3))
    jstate1, jaux = jmake_train_step(jtask, tx)(
        jstate, jax.tree.map(jnp.asarray, _batch(2)))
    tcfg = TrainConfig.from_config(cfg)
    start = _views({n: p.detach().clone() for n, p in
                    task.model.named_parameters()})
    opt, schedules = make_optimizer(tcfg, task.model, SPE)
    state = TrainState.create(task.model, opt, schedules, seed=0)
    aux = make_train_step(task, opt, schedules)(state, to_device(_batch(2),
                                                                 CPU))
    assert aux["loss"].item() == pytest.approx(float(jaux["loss"]),
                                               rel=LOSS_REL)
    assert _stats_rel(task.model,
                      jstate1.extra_vars["batch_stats"]) <= 1e-5
    return (task.model, _named(task.model, "grad"),
            _views(_params(task.model, jstate1.params)), opt, aux, start)


def _check_param(name, p, want, g, lr):
    diff = (p.detach() - want).abs()
    tight = 2 * 2.0 ** -23 * want.abs() + 1e-5 * lr
    if not name.endswith(ZERO_GRAD):  # noise steps either way
        big = g.abs() > SIGNIFICANT * g.abs().max()
        assert (diff <= tight)[big].all(), name
    assert (diff <= 2 * lr + tight).all(), name


def test_one_adamw_step_matches_jax():
    model, grads, want, opt, aux, _ = _one_step(_cfg(), seed=5)
    assert [g["name"] for g in opt.param_groups] == ["all"]
    assert aux["lr"] == pytest.approx(LR, rel=1e-7)
    for name, p in _named(model).items():
        _check_param(name, p, want[name], grads[name], LR)


# the groups' lrs of _split_lr (experiments/__init__.py:293-301)
SPLIT = {"image": 1e-4, "text": 1e-5, "projection": 1e-3}


def _group(name):
    for prefix, group in (("image_encoder.", "image"),
                          ("text_encoder.", "text")):
        if name.startswith(prefix):
            return group
    return "projection"


def test_split_lr_step_matches_multi_transform():
    cfg = _cfg("pretrain_resnet34_tinybert_split_lr")
    model, grads, want, opt, aux, _ = _one_step(cfg, seed=6)
    assert {g["name"]: g["lr"] for g in opt.param_groups} == SPLIT
    assert aux["group_lrs"] == SPLIT
    for name, p in _named(model).items():
        _check_param(name, p, want[name], grads[name], SPLIT[_group(name)])


def test_frozen_text_step_matches_multi_transform():
    """The text tower (lr 0) gets no update and no weight decay on either
    side, and no gradient on the port's; the rest steps at the base lr."""
    cfg = _cfg("pretrain_resnet34_tinybert_frozen_text")
    model, grads, want, opt, aux, start = _one_step(cfg, seed=7)
    assert [g["name"] for g in opt.param_groups] == ["image", "projection"]
    frozen = [n for n in start if n.startswith("text_encoder.")]
    assert frozen
    for name, p in _named(model).items():
        if name in frozen:
            assert not p.requires_grad and grads[name] is None, name
            assert torch.equal(p.detach(), start[name]), name
            assert torch.equal(want[name], start[name]), name
        else:
            _check_param(name, p, want[name], grads[name], LR)


def test_eval_embed_and_features_match_jax():
    """Eval mode on the running statistics, after a ``loss_fn`` has moved
    them on both sides."""
    cfg = _cfg()
    jtask, variables, task = _tasks(cfg, seed=8)
    batch = _batch(3)
    jbatch = jax.tree.map(jnp.asarray, batch)
    _, (mutated, _) = jtask.loss_fn(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        jbatch, jax.random.key(1))
    jvars = {"params": variables["params"], **mutated}
    task.loss_fn(to_device(batch, CPU), torch.Generator())
    stats = [b.clone() for b in task.model.buffers()]
    tb = to_device(batch, CPU)
    want = jtask.eval_fn(jvars, jbatch)
    got = task.eval_fn(tb)
    assert not task.model.training
    for key in ("img_emb", "txt_emb", "loss"):
        assert _rel(got[key].numpy(), want[key]) <= EVAL_REL, key
    assert torch.isfinite(got["txt_emb"][4]).all()
    assert _rel(task.embed_images_fn(tb).numpy(),
                jtask.embed_images_fn(jvars, jbatch)) <= EVAL_REL
    feats = task.features_fn(tb)
    assert feats.shape == (B, 128)
    assert _rel(feats.numpy(), jtask.features_fn(jvars, jbatch)) <= EVAL_REL
    assert all(torch.equal(a, b) for a, b in zip(stats,
                                                 task.model.buffers()))


@pytest.mark.parametrize("impl", ["gspmd", "shard_map"])
def test_infonce_impl_takes_the_jax_values_and_refuses_others(impl):
    """One card has no mesh: both values give the dense loss."""
    jtask, variables, task = _tasks(_cfg(mesh__infonce_impl=impl), seed=9)
    assert task.infonce_impl == impl
    batch = _batch(4)
    jloss, _ = jtask.loss_fn(variables["params"],
                             {"batch_stats": variables["batch_stats"]},
                             jax.tree.map(jnp.asarray, batch),
                             jax.random.key(2))
    loss, _ = task.loss_fn(to_device(batch, CPU), torch.Generator())
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_REL)
    for field, value in (("infonce_impl", "ring"),
                         ("loss_variant", "hinge")):
        bad = dataclasses.replace(TrainConfig.from_config(_cfg()).serve,
                                  **{field: value})
        with pytest.raises(ValueError, match=value):
            build_task(bad, TaskStatics(), CPU)


# --------------------------------------------------------------------------
# convert
# --------------------------------------------------------------------------

def test_convert_round_trips_the_dual_tower_and_raises_on_a_bad_tree():
    jtask, variables, task = _tasks(_cfg(), seed=10)
    sd = task.model.state_dict()
    raw = convert.flatten(variables)
    flat = convert.pack_qkv(raw)
    assert len(flat) == len(sd) == len(raw) - 4 * 2  # 2 layers, 6 -> 2
    for fkey, leaf in flat.items():
        got = sd[convert.torch_key(fkey)].numpy()
        if got.ndim == 4:
            got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        np.testing.assert_array_equal(got.reshape(np.shape(leaf)), leaf,
                                      fkey)
    assert convert.torch_key("params/text_encoder/layer1/attn/qkv/"
                             "kernel") == \
        "text_encoder.layers.1.attn.qkv.weight"
    assert sd["text_encoder.layers.0.attn.out.weight"].shape == (64, 64)
    # q | k | v: the key's [D, H, hd] kernel and [H, hd] bias in the middle
    attn = "params/text_encoder/layer1/attn/"
    np.testing.assert_array_equal(
        sd["text_encoder.layers.1.attn.qkv.weight"][:, 64:128].numpy(),
        raw[attn + "key/kernel"].reshape(64, 64))
    np.testing.assert_array_equal(
        sd["text_encoder.layers.1.attn.qkv.bias"][64:128].numpy(),
        raw[attn + "key/bias"].reshape(64))

    q = "params/text_encoder/layer0/attn/query/kernel"
    qkv = {f"params/text_encoder/layer0/attn/{p}/kernel":
           np.zeros((64, 4, 17), np.float32)
           for p in ("query", "key", "value")}
    for bad, err in (
            ({k: v for k, v in raw.items() if k != q}, KeyError),
            ({**raw, "params/text_encoder/layer2/ffn_ln/bias":
              np.zeros(64, np.float32)}, KeyError),
            ({**raw, q: np.zeros((64, 4, 17), np.float32)}, ValueError),
            ({**raw, **qkv}, ValueError),
            ({**raw, "params/text_projection":
              np.zeros((64, 64), np.float32)}, ValueError)):
        with pytest.raises(err, match="query|qkv|layer2|text_projection"):
            convert.state_dict_from_flax(bad, task.model)


def test_load_optimizer_state_covers_the_dual_towers_parameters():
    """optax adamw moments of every dual-tower parameter (the text tower's
    attention kernels, packed, the projections, logit_scale) land in
    ``torch.optim.AdamW``'s state."""
    cfg = _cfg()
    jtask, variables, task = _tasks(cfg, seed=11)
    tx = jmake_optimizer(cfg, variables["params"], SPE)
    jstate = JState.create(variables["params"],
                           {"batch_stats": variables["batch_stats"]}, tx,
                           jax.random.key(3))
    jstate1, _ = jmake_train_step(jtask, tx)(
        jstate, jax.tree.map(jnp.asarray, _batch(5)))
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate1.opt_state,
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    opt, _ = make_optimizer(TrainConfig.from_config(cfg), task.model, SPE)
    convert.load_optimizer_state(opt, task.model, jax.device_get(adam.mu),
                                 jax.device_get(adam.nu), int(adam.count))
    named = dict(task.model.named_parameters())
    mu = convert.flatten(jax.device_get(adam.mu))
    for fkey, torch_name, cols in (
            ("text_encoder/layer1/attn/key/kernel",
             "text_encoder.layers.1.attn.qkv.weight", slice(64, 128)),
            ("text_encoder/layer1/attn/value/bias",
             "text_encoder.layers.1.attn.qkv.bias", slice(128, 192)),
            ("text_encoder/word_embeddings/embedding",
             "text_encoder.word_embeddings.weight", None),
            ("logit_scale", "logit_scale", None),
            ("image_projection", "image_projection", None)):
        st = opt.state[named[torch_name]]
        got = st["exp_avg"] if cols is None else st["exp_avg"][..., cols]
        np.testing.assert_array_equal(got.numpy(),
                                      np.reshape(mu[fkey], got.shape))
        assert st["step"].item() == 1


# --------------------------------------------------------------------------
# image_dropout, and the pretrain run of train.setup
# --------------------------------------------------------------------------

def test_resnet_takes_no_feature_dropout_as_in_the_jax_registry():
    """The registry takes ``dropout_rate`` and passes it to no backbone, as
    the JAX registry does: in training mode a ResNet built with a rate
    gives what one built without gives, and its head is the identity."""
    m, _ = create_backbone("resnet_micro", dtype=torch.float32,
                           dropout_rate=0.25)
    plain, _ = create_backbone("resnet_micro", dtype=torch.float32)
    flax_init_(m, torch.Generator().manual_seed(0))
    plain.load_state_dict(m.state_dict())
    m.train()
    plain.train()
    x = torch.randn(3, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    feats = m.forward_features(x)
    assert torch.equal(m.forward_head(feats), feats)
    assert torch.equal(m(x), plain(x))


def test_image_dropout_is_ignored_as_the_jax_task_ignores_it():
    """``image_dropout`` 0.5: the loss matches the JAX task's, which is the
    same under two keys, and the port's is bit-equal to its own at 0."""
    cfg = _cfg(model__image_dropout=0.5)
    jtask, variables, task = _tasks(cfg, seed=12)
    _, _, plain = _tasks(_cfg(), seed=12)
    batch = _batch(6)
    jlosses_ = [float(jtask.loss_fn(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        jax.tree.map(jnp.asarray, batch), jax.random.key(k))[0])
        for k in (1, 2)]
    assert jlosses_[0] == jlosses_[1]
    a, _ = task.loss_fn(to_device(batch, CPU), torch.Generator())
    b, _ = plain.loss_fn(to_device(batch, CPU), torch.Generator())
    assert a.item() == b.item()
    assert a.item() == pytest.approx(jlosses_[0], rel=LOSS_REL)


def test_build_training_runs_the_pretrain_step_with_augmentation():
    """``build_training`` for a pretrain experiment (the run chip_smoke.py
    phase 20 times, cut to the test towers), the experiment's shear and
    noise on: finite losses, cosine's lr (the base lr at step 0), every
    parameter and the running statistics moving, ``logit_scale`` among
    them."""
    tcfg = TRAIN_EXPERIMENTS[EXP]
    tcfg = dataclasses.replace(tcfg, serve=dataclasses.replace(
        tcfg.serve, model="resnet_micro", text_model="microbert",
        image_size=SIZE, precision="fp32"), max_token_length=L)
    assert tcfg.augment().enabled and tcfg.augment().shear_deg == 5.0
    task, state, step = build_training(tcfg, CPU, SPE)
    assert isinstance(task, VisionLanguageTask)
    assert task.model.logit_scale.item() == pytest.approx(2.6592)
    start = {n: p.detach().clone() for n, p in
             task.model.named_parameters()}
    stats = [b.clone() for b in task.model.buffers()]
    rng = np.random.default_rng(4)
    auxes = train_steps(step, state, [
        random_pretrain_batch(rng, 4, SIZE, L, "microbert", full_length=f)
        for f in (False, True)])
    assert [a["lr"] for a in auxes] == [state.schedules[0](i)
                                        for i in range(2)]
    assert auxes[0]["lr"] == LR
    assert all(np.isfinite(a["loss"].item()) for a in auxes)
    for name, p in task.model.named_parameters():
        assert not torch.equal(p.detach(), start[name]), name
    assert all(not torch.equal(a, b) for a, b in zip(
        stats, task.model.buffers()))
    assert state.step == 2


def test_profile_slice_groups_and_times_the_pretrain_parts(monkeypatch):
    """``scripts/profile_slice.py``: the port's shear and noise kernels
    fall in its hand-written group, cuDNN's SDPA in the attention group,
    and ``--mode train``'s pretrain parts run (on the CPU here, the test
    towers; device busy 0 without a card)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "profile_slice.py")
    spec = importlib.util.spec_from_file_location("profile_slice", path)
    ps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps)

    def group(name):
        return next(g for g, pat in ps.GROUPS if re.search(pat, name))

    for name in ("void (anonymous namespace)::shear_rows_kernel<true>("
                 "float const*)", "(anonymous namespace)::shear_cols_kernel("
                 "float const*)", "void (anonymous namespace)::noise_kernel"
                 "<true>(float const*)", "void vlp::wg::wgmma_gemm_kernel"):
        assert group(name) == "hand-written", name
    assert group("cudnn_generated_fort_native_sdpa_sm90_flash_fprop") == \
        "attention (SDPA)"
    assert group("sm90_xmma_fprop_implicit_gemm_bf16bf16") == \
        "conv and GEMM (cuDNN, cuBLAS)"
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    tcfg = TRAIN_EXPERIMENTS[EXP]
    tcfg = dataclasses.replace(tcfg, serve=dataclasses.replace(
        tcfg.serve, model="resnet_micro", text_model="microbert",
        image_size=SIZE, precision="fp32"), max_token_length=L)
    task, state, _ = build_training(tcfg, CPU, SPE)
    parts = ps._vlp_parts(task, state, random_pretrain_batch(
        np.random.default_rng(0), 4, SIZE, L, "microbert"), 1)
    assert list(parts) == ["augmentation (#11, #12)", "image tower fwd+bwd",
                           "text tower fwd+bwd", "CLIP loss fwd+bwd",
                           "optimizer step"]
    assert all(busy >= 0 and window > 0 for busy, window in parts.values())
