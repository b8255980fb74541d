"""The native SPM / BPE merge loops on vocabularies built here: a byte-level
BPE vocabulary whose merges a short deterministic loop learns from a fixed
text (written as a gpt2-model GGUF, with the gpt-2 and llama-bpe
pre-tokenizers) and an SPM (llama-model) vocabulary scored by the same
merges. Four encoders give the same ids: the port's native and Python
paths, the JAX package's Python path (the behaviour reference) and its
native path. The merge loop and the SPM writer are chip_smoke.py's, which
builds its vocabularies the same way at full size."""

import pytest

from chip_smoke import learn_merges, write_spm_vocab
from prima_tpu.gguf.reader import GGUFModel as JGGUFModel
from prima_tpu.tokenizer import Tokenizer as JTokenizer
from prima_tpu.tokenizer import native as jtok_native
from prima_tpu_torch import native
from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.gguf.writer import GGUFWriter
from prima_tpu_torch.tokenizer import Tokenizer
from prima_tpu_torch.tokenizer import native as tok_native
from prima_tpu_torch.tokenizer.bpe import bytes_to_unicode

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="no g++")

# the texts of tests/test_native.py's tokenizer check
TEXTS = [
    "Hello world", " Hello world!  \n", "ied 4 ½ months",
    "你好，世界！ café \U0001f600\U0001f62e‍\U0001f4a8",
    "   leading spaces", "tab\tnewline\n mix 123 456.789",
    "a" * 300, ("word " * 50).strip(),
]
CORPUS = (
    "The quick brown fox jumps over the lazy dog. Hello world, hello there! "
    "A tokenizer merges the most frequent pair of symbols, again and again, "
    "until the vocabulary is full; the merges are ranked by when they were "
    "learned. Words like 'months', 'leading', 'spaces' and 'newline' recur: "
    "leading spaces, trailing spaces, tab\tnewline\n mixes 123 456.789 and "
    "café, naïve, façade; 4 ½ months. aaaa aaaa word word word. "
) * 4
N_MERGES = 150


def write_bpe(path: str, merges, pre: str) -> None:
    tokens = list(bytes_to_unicode().values())
    for a, b in merges:
        if a + b not in tokens:
            tokens.append(a + b)
    w = GGUFWriter(path, arch="llama")
    w.add_kv("tokenizer.ggml.model", "gpt2")
    w.add_kv("tokenizer.ggml.pre", pre)
    w.add_kv("tokenizer.ggml.tokens", tokens)
    w.add_kv("tokenizer.ggml.token_type", [1] * len(tokens))
    w.add_kv("tokenizer.ggml.merges", [f"{a} {b}" for a, b in merges])
    w.write()


@pytest.fixture(scope="module", params=["bpe-gpt-2", "bpe-llama-bpe", "spm"])
def tokenizers(request, tmp_path_factory):
    merges = learn_merges(CORPUS, N_MERGES)
    assert len(merges) == N_MERGES
    path = str(tmp_path_factory.mktemp("vocab") / f"{request.param}.gguf")
    if request.param == "spm":
        write_spm_vocab(path, merges, CORPUS)
    else:
        write_bpe(path, merges, request.param.split("-", 1)[1])
    tok, jtok = Tokenizer.from_gguf(GGUFModel.open(path)), JTokenizer.from_gguf(JGGUFModel.open(path))
    assert tok_native.get(tok.vocab) is not None
    return tok, jtok


def _python_ids(tok, text: str) -> list[int]:
    """The Python merge loop: the vocab's cached native tokenizer set aside."""
    v = tok.vocab
    saved = getattr(v, "_native_tok", False)  # False: not looked up yet
    object.__setattr__(v, "_native_tok", None)
    try:
        return tok.encode(text, add_special=False)
    finally:
        object.__setattr__(v, "_native_tok", saved)


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_four_encoders_agree(tokenizers, text):
    tok, jtok = tokenizers
    want = _python_ids(jtok, text)  # the JAX package's Python path
    assert _python_ids(tok, text) == want
    assert tok.encode(text, add_special=False) == want  # the port's native path
    if jtok_native.get(jtok.vocab) is not None:
        assert jtok.encode(text, add_special=False) == want
    # the merges did work: fewer ids than the text's bytes
    assert len(want) < len(text.encode("utf-8")) or len(text) < 4
