"""The port's recipes (`recipes/loader.py`, its own copy of the 7 builtin
YAML files) against JAX's loader (PyYAML): every recipe equal as a typed
dataclass, with and without dotlist overrides, and its resolved quant
config equal field for field; the port's YAML-subset reader equal to
`yaml.safe_load` on the subset and raising outside it."""

import os

import pytest
import yaml

from tensorrt_model_optimizer_tpu.recipes import loader as jl
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.recipes import loader as tl

RECIPES = sorted(os.listdir(jl.BUILTIN_ROOT))
OVERRIDES = [[], ["calib.num_batches=2", "quant.preset=FP8_DEFAULT_CFG"],
             ["calib.seq_len=128", "export_path=/tmp/x", "quant.overrides={'*mlp*': {enable: false}}"],
             ["calib.data=toks.npy", "quant.auto_quantize_bits=4.5", "save_state=null"]]


def test_builtin_copies_equal_jax():
    assert RECIPES == sorted(os.listdir(tl.BUILTIN_ROOT)) and len(RECIPES) == 7
    for name in RECIPES:
        with open(os.path.join(jl.BUILTIN_ROOT, name)) as f, open(os.path.join(tl.BUILTIN_ROOT, name)) as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: "+".join(o) or "none")
@pytest.mark.parametrize("name", RECIPES)
def test_recipes_equal_jax(name, overrides):
    j, t = jl.load_recipe(name, overrides), tl.load_recipe(name, overrides)
    assert type(t).__name__ == type(j).__name__
    assert vars(t.calib) == vars(j.calib) and vars(t.quant) == vars(j.quant)
    assert (t.model, t.export_path, t.save_state) == (j.model, j.export_path, j.save_state)
    jc, tc = j.resolve_quant_config(), t.resolve_quant_config()
    assert tc.algorithm == jc.algorithm
    assert tc.rules == tuple((p, convert.quantizer_cfg_from_jax(c)) for p, c in jc.rules)


def test_local_file_imports_builtin(tmp_path):
    p = tmp_path / "my.yaml"
    p.write_text('# modelopt-schema: ptq-recipe/v1\nimports: [int8_smoothquant.yaml]\nexport_path: /tmp/x\n'
                 'quant:\n  overrides:\n    "*mlp*": {enable: false}\n')
    j, t = jl.load_recipe(str(p)), tl.load_recipe(str(p))
    assert vars(t.quant) == vars(j.quant) and t.export_path == j.export_path == "/tmp/x"
    assert not t.resolve_quant_config().resolve("a.mlp.up_proj.weight_quantizer").enable
    local = tmp_path / "base_calib.yaml"  # a local file wins over the builtin of that name
    local.write_text("# modelopt-schema: ptq-recipe/v1\ncalib:\n  num_batches: 3\n")
    assert vars(tl.load_recipe(str(p)).calib) == vars(jl.load_recipe(str(p)).calib)
    bad = tmp_path / "bad.yaml"
    bad.write_text("quant: {preset: FP8_DEFAULT_CFG}")
    for mod in (jl, tl):
        with pytest.raises(ValueError, match="missing"):
            mod.load_recipe(str(bad))


SUBSET = [
    "a: 1\nb:\n  c: [x, y, 'q r']\n  d: {enable: false, \"k\": 1.5, n: ~}\n",
    "# c\nquant: {preset: FP8_DEFAULT_CFG}  # trailing\n",
    "x: yes\ny: null\nw: 1.0e-3\nf: -2.5\nq: \"a # b\"\nt: -5\nz: 0\nempty:\n",
    "k:\n  \"*mlp*\": {enable: false}\n  'it''s': [1, [2, 3], {}]\n",
    "",
]


@pytest.mark.parametrize("text", SUBSET)
def test_subset_reader_equals_pyyaml(text):
    assert tl.parse_yaml(text) == (yaml.safe_load(text) or {})


@pytest.mark.parametrize("text", ["a:\n  - 1\n  - 2\n", "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  text\n",
                                  "---\na: 1\n", "a: [1, 2\n", "a:\n    b: 1\n  c: 2\n", "a: 010\n", "a: 0x1F\n",
                                  "a: 1e-3\n", "a: .inf\n", "a: 1_000\n"])
def test_subset_reader_raises_outside_the_subset(text):
    with pytest.raises(tl.YamlSubsetError):
        tl.parse_yaml(text)
