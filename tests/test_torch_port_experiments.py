"""The port's copy of the config tree and the experiment registry
(``vlp_tpu_torch/config/core.py``, ``experiments.py``) against the JAX
package's ``vlp_tpu.config``: every registered experiment's ``to_dict()``
equal to ``get_experiment(name).to_dict()``, ``apply_overrides`` on valid
and invalid command lines (the same config or the same exception), and
every ``EXPERIMENTS``/``TRAIN_EXPERIMENTS`` entry equal to ``from_config``
of the port's own registry with the overrides its key names. All exact.
"""
import pytest

from vlp_tpu.config import Config as JConfig
from vlp_tpu.config import apply_overrides as japply
from vlp_tpu.config import get_experiment as jget
from vlp_tpu.config import list_experiments as jlist
from vlp_tpu_torch.config import (EXPERIMENTS, TRAIN_EXPERIMENTS, Config,
                                  ServeConfig, TrainConfig, apply_overrides,
                                  get_experiment, list_experiments,
                                  register_experiment)


def test_the_registry_holds_the_jax_experiments():
    assert list_experiments() == jlist()
    assert len(list_experiments()) > 60
    assert Config().to_dict() == JConfig().to_dict()


@pytest.mark.parametrize("name", jlist())
def test_each_experiment_matches_get_experiment(name):
    assert get_experiment(name).to_dict() == jget(name).to_dict()


OVERRIDES = [
    ["experiment=baseline_only_imaging_resnet34"],
    ["experiment=smoke_synthetic_pretrain", "data.image_size=32",
     "model.text_model=microbert", "trainer.early_stopping_monitor=null"],
    ["model.retrieval_ks=[1,2]", "model.clinical_hidden=[4,2]",
     "optimizer.lr=3e-4", "trainer.save_last=False", "data.name=pretrain"],
    ["experiment=pretrain_resnet34_tinybert", "mesh.infonce_impl=shard_map",
     "downstream_data.batch_size=16", "tags=['a','b']", "seed=7"],
    ["experiment=baseline_only_imaging_nest_small", "model.megakernel=false",
     "experiment=baseline_only_imaging_vit_base", "model.pretrained_ckpt=x"],
    ["trainer.profile_dir=None", "output_dir=some/where", "logger=wandb"],
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_apply_overrides_matches_jax(overrides):
    got = apply_overrides(Config(), overrides).to_dict()
    assert got == japply(JConfig(), overrides).to_dict()


@pytest.mark.parametrize("overrides,error", [
    (["model.no_such_field=1"], AttributeError),
    (["nothing.here=1"], AttributeError),
    (["model.model"], ValueError),
    (["experiment=no_such_experiment"], KeyError),
])
def test_apply_overrides_refuses_as_jax_does(overrides, error):
    with pytest.raises(error) as ours:
        apply_overrides(Config(), overrides)
    with pytest.raises(error) as theirs:
        japply(JConfig(), overrides)
    assert str(ours.value) == str(theirs.value)


def test_registering_a_name_twice_raises():
    with pytest.raises(ValueError, match="already registered"):
        register_experiment("baseline_only_imaging_resnet34")(lambda c: c)


def _port_config(key: str):
    name, *overrides = key.split(" ")
    return apply_overrides(get_experiment(name), overrides)


@pytest.mark.parametrize("key", sorted(EXPERIMENTS))
def test_entries_match_the_ports_own_registry(key):
    cfg = _port_config(key)
    assert EXPERIMENTS[key] == ServeConfig.from_config(cfg)
    assert TRAIN_EXPERIMENTS[key] == TrainConfig.from_config(cfg)
