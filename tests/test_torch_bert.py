"""The port's BERT encoder (models/bert.py) against the JAX package's on the
CPU: tiny bert and jina-bert-v2 GGUFs written with the JAX package's
GGUFWriter (f32, or Q8_0 blocks from its quantizer) and a WPM vocabulary,
loaded by both packages. Hidden states within 1e-5 of max |h| in f32,
under 32 tokens (the JAX side through its Pallas GEMV in interpret mode,
the port's through the GEMV wrapper's plain version) and over 32 (the
dense path); pool, embed and rerank (with and without a rank head) within
1e-5; the nomic-bert KeyError and the n_ctx_train overflow in both
packages; the JAX params carried across by params_from_numpy. The
server's embeddings mode is in test_torch_embed_tools.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from prima_tpu.gguf.constants import GGMLType
from prima_tpu.gguf.reader import GGUFModel as JGGUFModel
from prima_tpu.gguf.writer import GGUFWriter
from prima_tpu.models import bert as jbert
from prima_tpu.quant.quantize_np import quantize
from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models import bert
from prima_tpu_torch.models.llama import params_from_numpy
from test_torch_model import _flatten_jax

F32, Q8_0 = GGMLType.F32, GGMLType.Q8_0
TOL = 1e-5
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
WORDS = ["hello", "world", "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
         "cat", "sat", "on", "mat", "a", "b", "c", "d", "e", "f", "search", "query",
         "document", "tpu", "gpu", "card", "fast", "slow", "red", "blue", "green", "sky"]
PIECES = ["s", "ing", "ed", "er", "ly"]


def wpm_tokens(n_vocab: int) -> list[str]:
    """A WordPiece vocabulary in the GGUF's form: specials, word-initial
    pieces behind U+2581, continuations bare."""
    toks = SPECIALS + ["▁" + w for w in WORDS] + PIECES
    toks += [f"▁w{i}" for i in range(n_vocab - len(toks))]
    return toks


def write_bert(path, arch: str = "bert", ftype=F32, n_embd: int = 64, n_heads: int = 4,
               n_ff: int = 128, n_layers: int = 2, n_vocab: int = 96, n_pos: int = 64,
               rank_head: bool = False, pooling: int | None = None, seed: int = 0) -> str:
    """Write a tiny encoder GGUF of `arch` (bert, jina-bert-v2 with q/k
    norms and attn_norm_2, or nomic-bert's tensor table) and return its
    path. Projection matrices and the token table take `ftype`."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter(str(path), arch=arch)
    for key, val in {"block_count": n_layers, "embedding_length": n_embd,
                     "attention.head_count": n_heads, "feed_forward_length": n_ff,
                     "context_length": n_pos, "attention.layer_norm_epsilon": 1e-12,
                     "attention.causal": False}.items():
        w.add_kv(f"{arch}.{key}", val)
    if pooling is not None:
        w.add_kv(f"{arch}.pooling_type", pooling)
    toks = wpm_tokens(n_vocab)
    w.add_kv("tokenizer.ggml.model", "bert")
    w.add_kv("tokenizer.ggml.tokens", toks)
    w.add_kv("tokenizer.ggml.token_type", [3 if t in SPECIALS else 1 for t in toks])
    w.add_kv("tokenizer.ggml.unknown_token_id", 1)
    w.add_kv("tokenizer.ggml.cls_token_id", 2)
    w.add_kv("tokenizer.ggml.seperator_token_id", 3)
    w.add_kv("tokenizer.ggml.padding_token_id", 0)

    def mat(name, rows, cols, scale=0.08):
        x = (rng.standard_normal((rows, cols)) * scale).astype(np.float32)
        if ftype == F32 or cols % 32:
            w.add_tensor(name, x)
        else:
            w.add_tensor(name, quantize(x, ftype), ne=(cols, rows), ggml_type=ftype)

    def vec(name, n, around=0.0):
        w.add_tensor(name, (around + rng.standard_normal(n) * 0.05).astype(np.float32))

    def norm(name, n):
        vec(name + ".weight", n, 1.0)
        vec(name + ".bias", n)

    e = n_embd
    mat("token_embd.weight", n_vocab, e, scale=0.5)
    w.add_tensor("token_types.weight", (rng.standard_normal((2, e)) * 0.1).astype(np.float32))
    if arch == "bert":
        w.add_tensor("position_embd.weight",
                     (rng.standard_normal((n_pos, e)) * 0.1).astype(np.float32))
    norm("token_embd_norm", e)
    for i in range(n_layers):
        p = f"blk.{i}."
        if arch == "nomic-bert":  # RoPE and a fused QKV: no attn_q / position table
            mat(p + "attn_qkv.weight", 3 * e, e)
        else:
            for t in ("q", "k", "v"):
                mat(p + f"attn_{t}.weight", e, e)
                vec(p + f"attn_{t}.bias", e)
        mat(p + "attn_output.weight", e, e)
        vec(p + "attn_output.bias", e)
        norm(p + "attn_output_norm", e)
        mat(p + "ffn_up.weight", n_ff, e)
        if arch == "jina-bert-v2":
            mat(p + "ffn_gate.weight", n_ff, e)
            norm(p + "attn_q_norm", e)
            norm(p + "attn_k_norm", e)
            norm(p + "attn_norm_2", e)
        else:
            vec(p + "ffn_up.bias", n_ff)
        mat(p + "ffn_down.weight", e, n_ff)
        vec(p + "ffn_down.bias", e)
        norm(p + "layer_output_norm", e)
    if rank_head:
        w.add_tensor("cls.weight", (rng.standard_normal((e, e)) * 0.2).astype(np.float32))
        vec("cls.bias", e)
        w.add_tensor("cls.output.weight",
                     (rng.standard_normal((1, e)) * 0.5).astype(np.float32))
        vec("cls.output.bias", 1)
    w.write()
    return str(path)


def load_both(path: str):
    """(JAX runtime, port runtime on the CPU) of one GGUF, both in f32."""
    return (jbert.BertModelRuntime.load(path),
            bert.BertModelRuntime.load(path, device="cpu"))


def close(got, want, tol=TOL) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _ids(n: int, seed: int, n_vocab: int = 96) -> np.ndarray:
    ids = np.random.default_rng(seed).integers(5, n_vocab, n)
    ids[0], ids[-1] = 2, 3
    return ids.astype(np.int32)


CASES = [(arch, ft, n) for arch in ("bert", "jina-bert-v2") for ft in (F32, Q8_0)
         for n in (12, 40)]


@pytest.mark.parametrize("arch,ftype,n", CASES,
                         ids=[f"{a}-{f.name}-{n}" for a, f, n in CASES])
def test_hidden_states_match_jax(tmp_path, arch, ftype, n):
    path = write_bert(tmp_path / "m.gguf", arch, ftype)
    jrt, rt = load_both(path)
    ids = _ids(n, seed=n)
    # under 32 rows the JAX side takes its Pallas GEMV (interpret mode here)
    impl = "pallas" if n < 32 and ftype != F32 else "xla"
    want = np.asarray(jbert.bert_forward(jrt.params, jrt.cfg, jnp.asarray(ids[None]),
                                         matmul_impl=impl))
    with torch.no_grad():
        toks = torch.from_numpy(ids[None].astype(np.int64))
        got = bert.bert_forward(rt.params, rt.cfg, toks).numpy()
        plain = bert.bert_forward(rt.params, rt.cfg, toks, matmul_impl="plain").numpy()
    close(got, want)
    close(plain, want)


def test_config_matches_jax(tmp_path):
    for arch, pooling in (("bert", None), ("bert", 0), ("bert", 2), ("jina-bert-v2", 3)):
        path = write_bert(tmp_path / f"{arch}{pooling}.gguf", arch, pooling=pooling)
        jcfg = jbert.BertConfig.from_gguf(JGGUFModel.open(path))
        cfg = bert.BertConfig.from_gguf(GGUFModel.open(path))
        assert vars(cfg) == vars(jcfg)
    assert bert.BertConfig.from_gguf(GGUFModel.open(str(tmp_path / "bert0.gguf"))).pooling \
        == bert.PoolingType.MEAN  # pooling_type 0 reads as MEAN


@pytest.mark.parametrize("pooling", [bert.PoolingType.CLS, bert.PoolingType.MEAN,
                                     bert.PoolingType.LAST, bert.PoolingType.NONE],
                         ids=["cls", "mean", "last", "none"])
def test_pool_matches_jax(pooling):
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((3, 7, 16)).astype(np.float32)
    mask = np.ones((3, 7), np.float32)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    want = np.asarray(jbert.pool(jnp.asarray(hidden), jnp.asarray(mask), pooling))
    got = bert.pool(torch.from_numpy(hidden), torch.from_numpy(mask), pooling).numpy()
    close(got, want)


@pytest.mark.parametrize("arch,ftype", [("bert", F32), ("bert", Q8_0), ("jina-bert-v2", Q8_0)],
                         ids=["bert-F32", "bert-Q8_0", "jina-Q8_0"])
def test_embed_matches_jax(tmp_path, arch, ftype):
    jrt, rt = load_both(write_bert(tmp_path / "m.gguf", arch, ftype))
    texts = ["hello world", "searching documents on the card " * 6]
    got = rt.embed(texts)
    close(got, jrt.embed(texts))
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    for pooling in (bert.PoolingType.CLS, bert.PoolingType.LAST):
        close(rt.embed(texts[:1], normalize=False, pooling=pooling),
              jrt.embed(texts[:1], normalize=False, pooling=pooling))
    assert np.array_equal(rt.embed(texts, matmul_impl="plain"), got)


@pytest.mark.parametrize("head", [True, False], ids=["rank-head", "cosine"])
def test_rerank_matches_jax(tmp_path, head):
    jrt, rt = load_both(write_bert(tmp_path / "r.gguf", rank_head=head, ftype=Q8_0))
    assert rt.has_rank_head == jrt.has_rank_head == head
    docs = ["the quick brown fox", "a lazy dog sat", "red sky"]
    got = rt.rerank("quick fox", docs)
    want = jrt.rerank("quick fox", docs)
    close(got, want)
    assert list(np.argsort(-got)) == list(np.argsort(-want))


def test_nomic_bert_raises_like_jax(tmp_path):
    path = write_bert(tmp_path / "nomic.gguf", "nomic-bert")
    with pytest.raises(KeyError) as jerr:
        jbert.BertModelRuntime.load(path)
    with pytest.raises(KeyError) as err:
        bert.BertModelRuntime.load(path, device="cpu")
    assert str(err.value) == str(jerr.value) == "'missing tensor position_embd.weight'"


def test_text_past_n_ctx_train_fails_like_jax(tmp_path):
    jrt, rt = load_both(write_bert(tmp_path / "m.gguf", n_pos=16))
    text = " ".join(WORDS[:20])
    with pytest.raises(Exception):
        jrt.embed([text])
    with pytest.raises(RuntimeError):
        rt.embed([text])


def test_params_from_numpy_carries_bert(tmp_path):
    """The JAX package's encoder params (QTensor leaves, sigma-permuted)
    carried across give the JAX hidden states."""
    jrt, rt = load_both(write_bert(tmp_path / "m.gguf", "jina-bert-v2", Q8_0, rank_head=True))
    params = params_from_numpy(_flatten_jax(jrt.params), "cpu")
    ids = _ids(20, seed=2)
    want = np.asarray(jbert.bert_forward(jrt.params, jrt.cfg, jnp.asarray(ids[None])))
    with torch.no_grad():
        got = bert.bert_forward(params, rt.cfg, torch.from_numpy(ids[None].astype(np.int64)))
    close(got.numpy(), want)
    assert params["cls_out"].shape == (1, 64)


def test_runtime_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert.BertModelRuntime.load(write_bert(tmp_path / "m.gguf"))
