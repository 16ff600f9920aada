"""The port's MMLU harness (`utils/mmlu.py`) against the JAX package's:
prompt building and the CSV reader equal on synthlang's MMLU files; on the
trained anchor (f32), `mmlu_eval`'s choices identical to JAX's for the
unquantized model and for INT4_AWQ_CFG (2 subjects x 6 questions, k = 3);
and right-padded batches read the same last-position logits as one prompt
at a time (the causal mask: padding after a prompt changes none of its
logits)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_model_optimizer_tpu.models import hf_loader as jhf
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.utils import mmlu as jmmlu
from tensorrt_model_optimizer_tpu.utils import synthlang as jsynth
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as thf
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.utils import mmlu as tmmlu
from tensorrt_model_optimizer_tpu_torch.utils import synthlang as tsynth

ANCHOR = os.path.join(os.path.dirname(__file__), "..", "artifacts", "anchor-llama")
SUBJECTS = ("capitals", "arithmetic")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return jsynth.SynthLang(0).write_mmlu_data(str(tmp_path_factory.mktemp("mmlu")), n_test=6)


def test_prompts_and_reader_equal(data):
    assert tmmlu.list_subjects(data) == jmmlu.list_subjects(data)
    for subject in tmmlu.list_subjects(data):
        dev, test = tmmlu.read_subject(data, subject)
        assert (dev, test) == jmmlu.read_subject(data, subject)
        for row in test:
            assert tmmlu.format_example(row) == jmmlu.format_example(row)
            assert tmmlu.format_example(row, False) == jmmlu.format_example(row, False)
            for k in (0, 3, 5):
                assert tmmlu.build_prompt(dev, row, k) == jmmlu.build_prompt(dev, row, k)


def test_k_shot_backs_off_under_max_seq_len(data):
    dev, test = tmmlu.read_subject(data, "capitals")
    full = tsynth.encode(tmmlu.build_prompt(dev, test[0], 3))
    short = tmmlu.prompt_tokens(tsynth.encode, dev, test[0], 3, len(full) - 1)
    assert short == tsynth.encode(tmmlu.build_prompt(dev, test[0], 2))
    assert tmmlu.prompt_tokens(tsynth.encode, dev, test[0], 3, 1) == tsynth.encode(tmmlu.build_prompt(dev, test[0], 0))


def _jax_fn(fwd, bucket=32):
    """JAX's tool's padding (tools/accuracy_table.py): lengths rounded up to
    a bucket, so a few shapes compile."""
    def fn(tokens):
        T = tokens.shape[1]
        tp = -(-T // bucket) * bucket
        full = np.concatenate([tokens, np.zeros((tokens.shape[0], tp - T), np.int32)], axis=1)
        return np.asarray(fwd(jnp.asarray(full)))[:, :T]
    return fn


@pytest.fixture(scope="module")
def models():
    lang = jsynth.SynthLang(0)
    calib = [np.asarray(b) for b in lang.eval_batches(4, 4, 256, seed=555)]
    jcfg, jp = jhf.load_hf_checkpoint(ANCHOR, dtype=jnp.float32)
    tcfg, tp = thf.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device="cpu")
    jm = jptq.quantize(jcfg, jp, "INT4_AWQ_CFG", [jnp.asarray(c) for c in calib])
    tm = tptq.quantize(tcfg, tp, "INT4_AWQ_CFG", [torch.from_numpy(c) for c in calib], device="cpu")
    return {
        "unquantized": (jax.jit(lambda t: jllama.forward(jcfg, jp, t)[0]),
                        lambda t: tllama.forward(tcfg, tp, torch.from_numpy(t))[0]),
        "INT4_AWQ_CFG": (jax.jit(lambda t: jm.forward(t)[0]), lambda t: tm.forward(torch.from_numpy(t))[0]),
    }


@pytest.mark.parametrize("model", ["unquantized", "INT4_AWQ_CFG"])
def test_choices_equal_jax(data, models, model):
    jfwd, tfwd = models[model]
    kw = dict(subjects=SUBJECTS, k_shot=3, max_questions_per_subject=6)
    j = jmmlu.mmlu_eval(_jax_fn(jfwd), jsynth.encode, jsynth.ANSWER_TOKEN_IDS, data, **kw)
    t = tmmlu.mmlu_eval(tfwd, tsynth.encode, tsynth.ANSWER_TOKEN_IDS, data, batch=4, **kw)
    assert t["n"] == j["n"] == 12
    assert t["accuracy"] == j["accuracy"] and t["per_subject"] == j["per_subject"]
    jchoices = []
    for subject in SUBJECTS:
        dev, test = jmmlu.read_subject(data, subject)
        for row in test[:6]:
            toks = np.asarray(jsynth.encode(jmmlu.build_prompt(dev, row, 3)), np.int32)[None]
            jchoices.append(int(np.argmax(_jax_fn(jfwd)(toks)[0, -1][np.asarray(jsynth.ANSWER_TOKEN_IDS)])))
    assert t["choices"] == jchoices


def test_padded_batches_read_the_same_logits(data, models):
    """Prompts of unequal length, right-padded in one batch, against each
    prompt alone: the answer logits agree to f32 rounding (1e-5 of their
    scale; the padded batch's sums run over other shapes)."""
    tfwd = models["unquantized"][1]
    dev, test = tmmlu.read_subject(data, "arithmetic")
    prompts = [tmmlu.prompt_tokens(tsynth.encode, dev, row, k, 2048) for row, k in zip(test[:4], (0, 1, 2, 3))]
    assert len({len(p) for p in prompts}) == 4
    ids = np.asarray(tsynth.ANSWER_TOKEN_IDS)
    alone = tmmlu.answer_logits(lambda t: tfwd(t).numpy(), prompts, ids, batch=1)
    batched = tmmlu.answer_logits(lambda t: tfwd(t).numpy(), prompts, ids, batch=4)
    assert np.abs(batched - alone).max() <= 1e-5 * np.abs(alone).max()
