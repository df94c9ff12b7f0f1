"""Token <-> id vocabulary encoder for the TTS text path.

The port's copy of ``fastdiff_tpu/text/encoder.py`` (the port imports
nothing of the JAX package).

Contract-compatible with the reference's ``TokenTextEncoder``
(reference: utils/text_encoder.py:155-304): reserved ids
``<pad>``=0, ``<EOS>``=1, ``<UNK>``=2 precede the vocabulary when built from
a list; files store reserved tokens explicitly; ``encode`` maps a
space-separated token string; ``decode`` can strip padding/EOS;
``sil_phonemes`` are the non-alphabetic tokens.
"""

from __future__ import annotations

from typing import List, Optional

PAD = "<pad>"
EOS = "<EOS>"
UNK = "<UNK>"
SEG = "|"
RESERVED_TOKENS = [PAD, EOS, UNK]


class TokenTextEncoder:
    def __init__(self, vocab_filename: Optional[str] = None,
                 vocab_list: Optional[List[str]] = None,
                 replace_oov: Optional[str] = None):
        self._replace_oov = replace_oov
        if vocab_filename:
            with open(vocab_filename) as f:
                tokens = [line.strip() for line in f if line.strip() or True]
            tokens = [t for t in tokens if t != ""]
            self._id_to_token = dict(enumerate(tokens))
        else:
            assert vocab_list is not None
            tokens = [t for t in vocab_list if t not in RESERVED_TOKENS]
            self._id_to_token = dict(enumerate(RESERVED_TOKENS + tokens))
        self._token_to_id = {t: i for i, t in self._id_to_token.items()}
        self.pad_index = self._token_to_id[PAD]
        self.eos_index = self._token_to_id[EOS]
        self.unk_index = self._token_to_id[UNK]
        self.seg_index = self._token_to_id.get(SEG, self.eos_index)

    # -- encode / decode ---------------------------------------------------
    def encode(self, s: str) -> List[int]:
        tokens = s.strip().split()
        if self._replace_oov is not None:
            tokens = [t if t in self._token_to_id else self._replace_oov
                      for t in tokens]
        return [self._token_to_id[t] for t in tokens]

    def decode(self, ids, strip_eos: bool = False,
               strip_padding: bool = False) -> str:
        ids = list(ids)
        if strip_padding and self.pad_index in ids:
            ids = ids[: ids.index(self.pad_index)]
        if strip_eos and self.eos_index in ids:
            ids = ids[: ids.index(self.eos_index)]
        return " ".join(self.decode_list(ids))

    def decode_list(self, ids) -> List[str]:
        return [self._id_to_token.get(int(i), f"ID_{int(i)}") for i in ids]

    # -- introspection -----------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self._id_to_token)

    def __len__(self) -> int:
        return self.vocab_size

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    def seg(self) -> int:
        return self.seg_index

    def sil_phonemes(self) -> List[str]:
        return [t for t in self._id_to_token.values() if not t[0].isalpha()]

    def store_to_file(self, filename: str) -> None:
        with open(filename, "w") as f:
            for i in range(len(self._id_to_token)):
                f.write(self._id_to_token[i] + "\n")


def build_token_encoder(token_list_file: str) -> TokenTextEncoder:
    """Build an encoder from a JSON token list (the binarizer's phone_set
    format, reference: data_gen/tts/data_gen_utils.py build_phone_encoder)."""
    import json
    with open(token_list_file) as f:
        tokens = json.load(f)
    return TokenTextEncoder(vocab_list=tokens, replace_oov=UNK)
