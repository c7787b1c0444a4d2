"""The seam between the harness and what is model-specific: the module that
a configuration file names under "model" (bench/models/<model>.py). The
decoder's weights and HCCS constants are pinned by hash as the harness
made them before the seam; it reads a stated head_dim; and it refuses a
file that states structure it does not compute, as the seam refuses a
file that names no model."""
import hashlib

import pytest
import torch

from bench import spec
from bench.tests import tiny

BENCH = spec.Bench()
CELLS = {c["config"]: c["name"] for c in BENCH.spec["workloads"]}

# sha256 of the tiny weights and HCCS constants (tiny_sizes, seed 3, the
# CPU's generator of this torch release), as bench/weights.py made them
# before the model modules: the seam moved that code and changed no number
WEIGHTS = {
    "granite-3-2b":
        "7b7d56e635e2b8e383c946414e3f26b3cf261086489c46aa7ee3e3aa798bb5f8",
    "granite-moe-1b-a400m":
        "9ec00e75382a60943f779ca2f3b1c4340e6cc4fa31a6f5ecc717d7d101350e10",
}
HCCS = "0b9b1fc9d4bbed4fddb39799fa10cd8ff228239337377702c8beef98de46be16"

# structure the decoder does not compute, each key with a value that
# states it
UNSUPPORTED = [
    ("layer_types", ["attention", "mamba"]),
    ("sliding_window", 4096),
    ("shared_intermediate_size", 8192),
    ("tie_word_embeddings", False),
    ("attention_bias", True),
    ("mlp_bias", True),
    ("hidden_act", "gelu"),
    ("position_embedding_type", "nope"),
]


def digest(tree) -> str:
    """sha256 over a tree's leaves in key order: path, dtype, shape, bytes."""
    h = hashlib.sha256()

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + "/" + k)
            return
        t = t.detach().cpu().contiguous()
        h.update(f"{path} {t.dtype} {tuple(t.shape)}\n".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    walk(tree, "")
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_weights_and_hccs_are_the_pinned_ones(name):
    conf = tiny.config(BENCH, CELLS[name])
    model = BENCH.model(conf)
    cfg = model.reference_config(conf)
    assert digest(model.make_weights(cfg, 3, "cpu")) == WEIGHTS[name]
    assert digest(model.make_hccs(cfg, 3, "cpu")) == HCCS


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_every_configuration_names_the_decoder(name):
    assert BENCH.config(name)["model"] == "decoder"


def test_a_stated_head_dim_is_read():
    conf = BENCH.config("granite-3-2b")
    model = BENCH.model(conf)
    assert model.reference_config(conf)["head_dim"] == 2048 // 32
    wide = dict(conf, head_dim=128)
    assert model.reference_config(wide)["head_dim"] == 128
    assert model.attention_shape(model.reference_config(wide)) == (32, 8, 128)
    assert model.port_config(wide).head_dim == 128
    small = dict(wide, **model.tiny_sizes(wide))
    assert small["head_dim"] == 32
    assert small["hidden_size"] // small["num_attention_heads"] == 16


@pytest.mark.parametrize("key,value", UNSUPPORTED,
                         ids=[k for k, _ in UNSUPPORTED])
def test_decoder_refuses_what_it_does_not_compute(key, value):
    conf = dict(BENCH.config("granite-3-2b"), **{key: value})
    model = BENCH.model(conf)
    for view in (model.reference_config, model.port_config):
        with pytest.raises(ValueError, match=key):
            view(conf)


def test_a_file_without_a_model_is_refused():
    conf = BENCH.config("granite-moe-1b-a400m")
    conf.pop("model")
    with pytest.raises(ValueError, match='"model"'):
        BENCH.model(conf)
