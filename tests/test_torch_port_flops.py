"""The port's analytic 2*MAC FLOP counter (``vlp_tpu_torch/utils/flops.py``)
against the JAX package's ``analytic_flops``: exactly equal on
``tests/test_flops.py``'s closed-form cases (matmul, batched, conv, grouped,
strided) and towers (ViT-B/16 with a 2-logit head, NesT-Small, ResNet34 on
one channel with its head), and on the VLP model (ResNet34 + TinyBERT, both
towers and projections) at batch 2, 224 pixels and 40 tokens; a hand-written
kernel's autograd Function keeps its products in the count; nothing is
computed.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from vlp_tpu.config import Config as JConfig
from vlp_tpu.config import apply_overrides as japply
from vlp_tpu.models import nest as jnest
from vlp_tpu.models import resnet as jresnet
from vlp_tpu.models import vit as jvit
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.utils.flops import analytic_flops as jflops
from vlp_tpu_torch.config.core import Config, apply_overrides
from vlp_tpu_torch.models.registry import create_backbone
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.models.vit import Dense
from vlp_tpu_torch.ops.block_attention import attend_qkv
from vlp_tpu_torch.utils.flops import analytic_flops

VLP = ["model.task=vision_language", "model.model=resnet34",
       "model.text_model=tinybert"]


def _sds(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _zeros(*shape):
    return torch.zeros(*shape)


def _conv(stride, groups):
    def fn(x, w):  # NHWC, HWIO as the JAX case
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        stride=stride, padding=w.shape[0] // 2,
                        groups=groups)
    return fn


def _jconv(stride, groups):
    def fn(x, w):
        return lax.conv_general_dilated(
            x, w, (stride, stride), "SAME", feature_group_count=groups,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return fn


CLOSED = {
    "matmul": (lambda a, b: a @ b, lambda a, b: a @ b,
               ((128, 128), (128, 128)), 2 * 128 ** 3),
    "batched": (torch.bmm,
                lambda a, b: lax.dot_general(a, b, (((2,), (1,)),
                                                    ((0,), (0,)))),
                ((4, 16, 32), (4, 32, 8)), 2 * 4 * 16 * 8 * 32),
    "conv": (_conv(1, 1), _jconv(1, 1), ((1, 224, 224, 3), (3, 3, 3, 64)),
             2 * 224 * 224 * 64 * 3 * 3 * 3),
    "grouped": (_conv(1, 8), _jconv(1, 8), ((1, 16, 16, 8), (3, 3, 1, 8)),
                2 * 16 * 16 * 8 * 3 * 3 * 1),
    "strided": (_conv(2, 1), _jconv(2, 1), ((1, 224, 224, 3), (7, 7, 3, 64)),
                2 * 112 * 112 * 64 * 7 * 7 * 3),
}


@pytest.mark.parametrize("case", sorted(CLOSED))
def test_closed_form_equals_jax(case):
    fn, jfn, shapes, want = CLOSED[case]
    got = analytic_flops(fn, *(_zeros(*s) for s in shapes))
    assert got == want == jflops(jfn, *(_sds(s) for s in shapes))


def test_elementwise_is_free_and_sdpa_is_two_products():
    assert analytic_flops(lambda x: torch.tanh(x) + x * 2,
                          _zeros(1024, 1024)) == 0
    q = _zeros(2, 3, 10, 8)
    k = _zeros(2, 3, 12, 8)
    v = _zeros(2, 3, 12, 5)
    assert analytic_flops(F.scaled_dot_product_attention, q, k, v) == \
        2 * 2 * 3 * 10 * 12 * (8 + 5)


def test_a_kernel_wrapper_keeps_its_products():
    """``attend_qkv`` (an autograd Function around the kernel) counts its
    plain version's two products."""
    qkv = _zeros(2, 10, 3 * 64).requires_grad_(True)
    want = 2 * 2 * 2 * 10 * 10 * 32 * 2
    assert analytic_flops(lambda t: attend_qkv(t, 2), qkv) == want


def _jax_tower(name):
    if name == "vit":
        return jvit.vit_base_patch16_224(num_classes=2), 3, {}
    if name == "nest":
        return jnest.NesT(), 3, {}
    return jresnet.resnet34(num_classes=2), 1, {"train": False}


def _port_tower(name):
    backbone = {"vit": "vit_base_patch16_224", "nest": "nest_small",
                "resnet34": "resnet34"}[name]
    chans = 1 if name == "resnet34" else 3
    model, width = create_backbone(backbone, in_chans=chans)
    model.eval()
    head = None if name == "nest" else Dense(width, 2)
    return (lambda x: model(x) if head is None else head(model(x))), chans


@pytest.mark.parametrize("name", ["vit", "nest", "resnet34"])
def test_towers_equal_jax(name):
    m, chans, kw = _jax_tower(name)
    x = _sds((1, 224, 224, chans), jnp.bfloat16)
    v = jax.eval_shape(lambda: m.init(jax.random.key(0),
                                      jnp.zeros(x.shape, x.dtype)))
    want = jflops(lambda p, xx: m.apply(p, xx, **kw), v, x)
    fn, _ = _port_tower(name)
    assert analytic_flops(fn, _zeros(1, 224, 224, chans)) == want


def test_vlp_towers_equal_jax():
    """Both towers and their projections (the forward the VLP step runs
    three times' worth of) at batch 2."""
    jcfg = japply(JConfig(), VLP)
    jtask = jbuild_task(jcfg, JStatics(mean=128.0, std=30.0))
    batch = {"image_u8": _sds((2, 224, 224), jnp.uint8),
             "input_ids": _sds((2, 40), jnp.int32),
             "attention_mask": _sds((2, 40), jnp.int32)}
    zeros = {k: jnp.zeros(v.shape, v.dtype) for k, v in batch.items()}
    variables = jax.eval_shape(
        lambda: jtask.init_variables(jax.random.key(0), zeros))
    want = jflops(lambda v, b: jtask.model.apply(
        v, jtask._prep_eval(b, jtask.statics), b["input_ids"],
        b["attention_mask"]), variables, batch)
    task = build_task(apply_overrides(Config(), VLP),
                      TaskStatics(mean=128.0, std=30.0))
    task.model.eval()
    tb = {"image_u8": torch.zeros(2, 224, 224, dtype=torch.uint8),
          "input_ids": torch.zeros(2, 40, dtype=torch.int32),
          "attention_mask": torch.ones(2, 40, dtype=torch.int32)}
    got = analytic_flops(lambda b: task.model(
        task._prep_eval(b), b["input_ids"], b["attention_mask"]), tb)
    assert got == want > 0
