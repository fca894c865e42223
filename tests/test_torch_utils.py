"""Port parity of `diffews_tpu_torch.utils` and the tokenizer copy against
the JAX package's (CPU):

  - `seeding.fix_randseed`: Python's and NumPy's streams equal JAX's after
    the same seed, and torch's generator seeded;
  - `ensemble.ensemble_depths`: equal to JAX's (the same float64 NumPy and
    scipy BFGS: to 1e-6);
  - `batchsize.find_batch_size` at JAX's test values (`hbm_gib` given), and
    a raise where JAX assumes 16 GiB;
  - `profiling`: `StageTimer` counts and formats like JAX's (a raising
    stage counted), and a CPU `trace` writes a Chrome trace with the
    annotation;
  - `data.tokenizer.CLIPTokenizer`: ids, padding, truncation and `decode`
    equal JAX's on `tests/test_tokenizer.py`'s synthetic vocabulary.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from diffews_tpu.data import tokenizer as JT
from diffews_tpu.utils import batchsize as JB
from diffews_tpu.utils import ensemble as JE
from diffews_tpu.utils import seeding as JSd
from diffews_tpu_torch.data import tokenizer as TT
from diffews_tpu_torch.utils import batchsize as TB
from diffews_tpu_torch.utils import ensemble as TE
from diffews_tpu_torch.utils import profiling as TPr
from diffews_tpu_torch.utils import seeding as TSd
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _streams():
    return ([random.random() for _ in range(5)], np.random.rand(5).tolist(),
            np.random.randint(0, 1000, 5).tolist())


@pytest.mark.parametrize("seed", [0, 1234])
def test_fix_randseed_streams_match_jax(seed):
    assert JSd.fix_randseed(seed) == seed
    want = _streams()
    assert TSd.fix_randseed(seed) == seed
    got = _streams()
    assert got == want
    t1 = torch.rand(4)
    TSd.fix_randseed(seed)
    assert torch.equal(torch.rand(4), t1)


def test_fix_randseed_none_draws_a_seed():
    np.random.seed(5)
    want = JSd.fix_randseed(None)
    np.random.seed(5)
    assert TSd.fix_randseed(None) == want


@pytest.mark.parametrize("reduction", ["median", "mean"])
def test_ensemble_depths_matches_jax(reduction):
    rng = np.random.default_rng(3)
    base = rng.random((24, 30))
    members = np.stack([base * s + t + rng.normal(0, 0.01, base.shape)
                        for s, t in ((1.0, 0.0), (2.0, 0.5), (0.5, -0.2), (1.5, 0.1))])
    want = JE.ensemble_depths(members, max_iter=20, reduction=reduction)
    got = TE.ensemble_depths(members, max_iter=20, reduction=reduction)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        TE.ensemble_depths(members, reduction="max")


@pytest.mark.parametrize("args", [(100, 512, True, 16), (100, 512, False, 16),
                                  (100, 768, True, 16), (4, 512, True, 16),
                                  (100, 512, True, 2), (100, 512, True, 80),
                                  (100, 1024, True, 80), (100, 768, False, 8)])
def test_find_batch_size_matches_jax(args):
    e, res, bf16, gib = args
    assert TB.find_batch_size(e, res, bf16=bf16, hbm_gib=gib) == \
        JB.find_batch_size(e, res, bf16=bf16, hbm_gib=gib)


def test_find_batch_size_raises_without_device_memory():
    """JAX falls back to 16 GiB when it cannot read the device; the port
    raises on a CPU device instead of guessing."""
    with pytest.raises(RuntimeError, match="hbm_gib"):
        TB.find_batch_size(8, 512, device="cpu")


def test_stage_timer_matches_jax_timer():
    from diffews_tpu.utils import profiling as JPr

    timers = {"jax": JPr.StageTimer(sync=False), "torch": TPr.StageTimer(sync=True,
                                                                        device="cpu")}
    for st in timers.values():
        for name in ("a", "a", "b"):
            with st.stage(name):
                pass
        with pytest.raises(RuntimeError):
            with st.stage("boom"):
                raise RuntimeError("x")
    j, t = timers["jax"], timers["torch"]
    assert dict(t.counts) == dict(j.counts) == {"a": 2, "b": 1, "boom": 1}
    s = t.summary()
    assert "a:" in s and "x2" in s and "b:" in s and "boom:" in s


def test_trace_writes_chrome_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with TPr.trace(logdir):
        with TPr.annotate("annotated-step"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "annotated-step" for e in events)


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """`tests/test_tokenizer.py`'s synthetic vocabulary: the byte alphabet,
    its end-of-word forms, a few merges and the two special tokens."""
    d = tmp_path_factory.mktemp("tok")
    byte_vocab = list(JT._bytes_to_unicode().values())
    vocab = {}
    for ch in byte_vocab:
        vocab[ch] = len(vocab)
    for ch in byte_vocab:
        vocab[ch + "</w>"] = len(vocab)
    merges = ["t h", "th e</w>", "a n", "an d</w>", "i n", "in g</w>",
              "h e", "he l", "hel l", "hell o</w>", "c a", "ca t</w>"]
    for m in merges:
        tok = m.replace(" ", "")
        if tok not in vocab:
            vocab[tok] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(d / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(d / "merges.txt", "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(d)


TEXTS = ["", "hello", "the cat and the hat", "Hello, World!  123", "thing-in-the-box",
         "a   b\t c", "don't", "café &amp; cat", "cat " * 100]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_jax(vocab_dir, text):
    mine, ref = TT.CLIPTokenizer.from_pretrained(vocab_dir), \
        JT.CLIPTokenizer.from_pretrained(vocab_dir)
    assert mine.encode(text) == ref.encode(text)
    for kw in ({"padding": "do_not_pad"}, {"padding": "max_length", "max_length": 77},
               {"max_length": 10}, {"max_length": 10, "truncation": False}):
        got, want = mine(text, **kw).input_ids, ref(text, **kw).input_ids
        assert got.dtype == want.dtype and got.tolist() == want.tolist(), kw
    ids = mine.encode(text)
    assert mine.decode(ids) == ref.decode(ids)
    assert (mine.bos_token_id, mine.eos_token_id, mine.pad_token_id) == \
        (ref.bos_token_id, ref.eos_token_id, ref.pad_token_id)


def test_tokenizer_reads_a_checkpoint_root(vocab_dir, tmp_path):
    """A checkpoint root with a `tokenizer/` subdirectory loads as in JAX."""
    import shutil

    shutil.copytree(vocab_dir, tmp_path / "tokenizer")
    ids = TT.CLIPTokenizer.from_pretrained(str(tmp_path))("hello cat").input_ids
    assert ids.tolist() == JT.CLIPTokenizer.from_pretrained(str(tmp_path))(
        "hello cat").input_ids.tolist()
