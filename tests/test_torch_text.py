"""The port's text front end (``fastdiff_tpu_torch/text``) against the JAX
package's (``fastdiff_tpu/text``): every registered processor,
``normalize_text``, ``normalize_zh``, ``zh_g2p``, ``syllabify`` and the
token encoder give exactly JAX's output on the sentences of
``tests/test_text_and_metrics.py``, ``tests/test_zh_text.py`` and
``tests/test_syllabify.py``."""

import json

import pytest

from fastdiff_tpu.text import encoder as jax_encoder
from fastdiff_tpu.text import normalize as jax_normalize
from fastdiff_tpu.text import processors as jax_processors
from fastdiff_tpu.text import syllabify as jax_syllabify
from fastdiff_tpu.text import zh_g2p as jax_zh_g2p
from fastdiff_tpu.text import zh_norm as jax_zh_norm
from fastdiff_tpu_torch.text import encoder, normalize, processors, syllabify
from fastdiff_tpu_torch.text import zh_g2p, zh_norm

EN = ["Dr. Smith paid $5.", "In 1984, 2nd place!", "Hello   WORLD—now",
      "Hi there", "Test 12.", "hello world", "42 cats", "  hi  ",
      "The 3rd of May, 2021: Mr. Jones' 1,500 cats cost $3.50 (or 12%)?"]
ZH = ["今天8:30，气温-3℃。", "今天SEP气温低", "2021年3月15日", "2021-03-15",
      "2021/3/5", "8:05", "12:00", "10.5%", "3‰", "1/3", "3~5", "¥12.50",
      "气温-3℃", "13812345678", "010-12345678", "１２３", "共123个",
      "中国", "你好", "银行", "行走", "音乐", "快乐", "不是", "不好", "一个",
      "一天", "987654321098"]
WORDS = ["banana", "window", "strength", "a", "make", "stone", "butter",
         "rhythm", "yes", "123", "", "Window", "syllable", "extraordinary"]

CASES = ([(name, text) for name in ("en", "en_syl", "grapheme")
          for text in EN]
         + [(name, text) for name in ("zh", "zh_g2pM", "zh_song_seg",
                                      "zh_g2pM_song_seg")
            for text in ZH])


def test_registries_match():
    assert sorted(processors.PROCESSORS) == sorted(jax_processors.PROCESSORS)
    assert sorted(processors.PROCESSORS) == [
        "en", "en_syl", "grapheme", "zh", "zh_g2pM", "zh_g2pM_song_seg",
        "zh_song_seg"]


@pytest.mark.parametrize("name,text", CASES)
def test_processor_matches_jax(name, text):
    ours = processors.get_txt_processor_cls(name)
    assert ours.process(text) == \
        jax_processors.get_txt_processor_cls(name).process(text)


@pytest.mark.parametrize("module,fn,args", [
    *[("normalize", "normalize_text", (t,)) for t in EN],
    *[("normalize", "number_to_words", (n,))
      for n in (0, 7, 15, 42, 100, 215, 1000, 1000000, 1984)],
    *[("zh_norm", "normalize_zh", (t,)) for t in ZH],
    *[("zh_norm", "num_to_hanzi", (n,))
      for n in (0, 103, 1030, 10001, 100010000, 200500030)],
    *[("zh_g2p", "zh_g2p", (t,)) for t in ZH[17:]],
    *[("syllabify", "syllabify", (w,)) for w in WORDS],
])
def test_front_end_function_matches_jax(module, fn, args):
    ours = {"normalize": normalize, "zh_norm": zh_norm, "zh_g2p": zh_g2p,
            "syllabify": syllabify}[module]
    ref = {"normalize": jax_normalize, "zh_norm": jax_zh_norm,
           "zh_g2p": jax_zh_g2p, "syllabify": jax_syllabify}[module]
    assert getattr(ours, fn)(*args) == getattr(ref, fn)(*args)


def test_token_encoder_matches_jax(tmp_path):
    phones = sorted({p for text in EN for p in
                     processors.get_txt_processor_cls("en").process(text)[0]})
    path = tmp_path / "phone_set.json"
    path.write_text(json.dumps(phones))
    ours = encoder.build_token_encoder(str(path))
    ref = jax_encoder.build_token_encoder(str(path))
    assert ours.vocab_size == ref.vocab_size == len(phones) + 3
    for text in EN + ["zz qq"]:
        ph = " ".join(processors.get_txt_processor_cls("en").process(text)[0])
        ids = ours.encode(ph + " OOV")
        assert ids == ref.encode(ph + " OOV")
        assert ours.decode(ids) == ref.decode(ids)
    assert ours.sil_phonemes() == ref.sil_phonemes()
    listed = encoder.TokenTextEncoder(vocab_list=["a", "b", "|"])
    assert (listed.pad(), listed.eos(), listed.unk(), listed.seg()) == \
        (0, 1, 2, 5)
    listed.store_to_file(str(tmp_path / "vocab.txt"))
    back = jax_encoder.TokenTextEncoder(
        vocab_filename=str(tmp_path / "vocab.txt"))
    assert back.encode("a b |") == listed.encode("a b |") == [3, 4, 5]
