"""The port's LLM adapters and query rewriter (copies) on the CPU, held
against the JAX package.

- ``FakeLLM``: the same messages give the same completions, synthesized
  structured outputs and embeddings in both packages.
- ``OpenAICompatLLM`` against the in-process OpenAI-protocol server of the
  JAX package's ``tests/test_llm.py`` (no network): chat, structured
  output, streaming with usage, embeddings, retries, 4xx, models.
- ``MultiQueryRewriter`` / ``RewriteRetriever``: the device path (one
  ``multi_query_search`` over every variant) and the host path (fused
  ``invoke_batch``) give the JAX package's documents, and agree with each
  other.
"""

import asyncio

import pytest
from pydantic import BaseModel

from rag_arc_tpu.index.vector_store import TPUVectorStore
from rag_arc_tpu.llm import FakeLLM as JaxFake
from rag_arc_tpu.llm import OpenAICompatLLM as JaxOpenAI
from rag_arc_tpu.models.embeddings import HashEmbeddings as JaxHash
from rag_arc_tpu.retrieval import rewrite as jrw
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
from rag_arc_tpu_torch.llm import FakeLLM, LLMBase, OpenAICompatLLM
from rag_arc_tpu_torch.models.embeddings import HashEmbeddings
from rag_arc_tpu_torch.retrieval import rewrite as trw
from tests.test_llm import Answer, _Handler, _ModelsHandler, server  # noqa: F401 (fixture)

CORPUS = [
    "felines purr when content",
    "the cat sat on the mat",
    "automobiles require regular maintenance",
    "cars need oil changes",
    "tpu pods scale to thousands of chips",
    "kittens chase yarn balls",
    "engines need fresh oil",
]
IDS = [f"c{i}" for i in range(len(CORPUS))]
MSG = [{"role": "user", "content": "hello there"}]


def test_base_validation_and_formatting():
    for bad in ([], [{"role": "nope", "content": "x"}], [{"content": "x"}]):
        with pytest.raises(ValueError):
            LLMBase.validate_input(bad)
    msgs = LLMBase.format_messages("q", system="sys",
                                   history=[{"role": "assistant", "content": "prev"}])
    assert [m["role"] for m in msgs] == ["system", "assistant", "user"]


def test_fake_llm_matches_jax():
    j, t = JaxFake(track_usage=True), FakeLLM(track_usage=True)
    assert t.chat(MSG) == j.chat(MSG)
    assert t.parse_chat(MSG, Answer) == j.parse_chat(MSG, Answer)
    assert t.embed(["a", "b c"]) == j.embed(["a", "b c"])
    assert t.get_model_info() == j.get_model_info()
    canned = FakeLLM(responses=["first", {"title": "t", "tags": ["a"], "confidence": 0.9}])
    assert canned.chat(MSG) == "first"
    assert canned.parse_chat(MSG, Answer).tags == ["a"]
    hook = FakeLLM(responder=lambda msgs, fmt: "hook:" + msgs[-1]["content"])
    assert hook.chat(MSG) == "hook:hello there"
    assert asyncio.run(FakeLLM(responses=["x"]).achat(MSG)) == "x"


def test_openai_compat_matches_jax(server):  # noqa: F811
    j = JaxOpenAI("test-model", base_url=server, track_usage=True)
    t = OpenAICompatLLM("test-model", base_url=server, track_usage=True)
    assert t.chat([{"role": "user", "content": "ping"}]) == j.chat(
        [{"role": "user", "content": "ping"}]) == "echo:ping"
    assert t.parse_chat(MSG, Answer) == j.parse_chat(MSG, Answer)
    assert list(t.stream_chat(MSG)) == list(j.stream_chat(MSG)) == ["Hel", "lo"]
    assert t.usage.as_dict() == j.usage.as_dict()

    async def collect(llm):
        return [p async for p in llm.astream_chat(MSG)]

    assert "".join(asyncio.run(collect(t))) == "Hello"
    emb = OpenAICompatLLM("text-embedding-test", base_url=server)
    assert emb.embed(["abc", "de"]) == [[3.0, 1.0], [2.0, 1.0]]
    with pytest.raises(ValueError, match="embedding"):
        t.embed(["a"])
    with pytest.raises(RuntimeError, match="HTTP 400.*bad schema"):
        t.chat([{"role": "user", "content": "RAISE400"}])
    _Handler.fail_first_n, _Handler.failures = 1, 0
    try:
        retry = OpenAICompatLLM("m", base_url=server, max_retries=2)
        assert retry.chat([{"role": "user", "content": "retry"}]) == "echo:retry"
    finally:
        _Handler.fail_first_n = 0


def test_openai_compat_unreachable_and_models():
    import threading
    from http.server import HTTPServer

    llm = OpenAICompatLLM("m", base_url="http://127.0.0.1:9", max_retries=2, timeout=0.3)
    with pytest.raises(ConnectionError):
        llm.chat(MSG)
    httpd = HTTPServer(("127.0.0.1", 0), _ModelsHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_port}/v1"
        assert OpenAICompatLLM("m", base_url=url).get_available_models() == ["m-1", "m-2"]
    finally:
        httpd.shutdown()


# -- the rewriter ------------------------------------------------------------------


@pytest.fixture
def retrievers():
    j = TPUVectorStore(JaxHash(dim=64))
    j.add_texts(CORPUS, ids=IDS)
    t = TorchVectorStore(HashEmbeddings(dim=64), device="cpu")
    t.add_texts(CORPUS, ids=IDS)
    return j.as_retriever(), t.as_retriever()


class _Opaque:
    """Hides ``multi_query_search``: the rewrite retriever takes its host
    path (``invoke_batch`` + RRFusion)."""

    name = "opaque"

    def __init__(self, r):
        self._r = r

    def invoke_batch(self, queries, **kw):
        return self._r.invoke_batch(queries, **kw)


def test_rewriter_dedups_limits_and_degrades():
    canned = trw.QueryVariants(queries=["cats", "Cats", "felines", "kittens", "more"])
    assert trw.MultiQueryRewriter(FakeLLM(responses=[canned]), n_variants=3).rewrite(
        "cats") == ["felines", "kittens", "more"]

    class Boom(FakeLLM):
        def parse_chat(self, *a, **k):
            raise RuntimeError("llm down")

    assert trw.MultiQueryRewriter(Boom()).rewrite("q") == []


@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("variants,query", [
    (["felines purr"], "cat mat"), (["cars maintenance", "oil changes"], "automobile upkeep"),
    ([], "tpu chips"),
])
def test_rewrite_retriever_matches_jax(retrievers, host, variants, query):
    jr, tr = retrievers
    if host:
        jr, tr = _Opaque(jr), _Opaque(tr)
    jrr = jrw.RewriteRetriever(jr, jrw.MultiQueryRewriter(
        JaxFake(responses=[jrw.QueryVariants(queries=variants)])), top_k=3, k_per_query=4)
    trr = trw.RewriteRetriever(tr, trw.MultiQueryRewriter(
        FakeLLM(responses=[trw.QueryVariants(queries=variants)])), top_k=3, k_per_query=4)
    want, got = jrr.invoke(query), trr.invoke(query)
    assert [d.id for d in got] == [d.id for d in want]
    for g, w in zip(got, want):
        assert abs(g.metadata["fusion_score"] - w.metadata["fusion_score"]) < 1e-6
    assert trr.last_variants() == variants


def test_rewrite_device_and_host_paths_agree(retrievers):
    _, tr = retrievers
    calls = []
    store = tr.vectorstore
    orig = store.multi_query_search

    def spy(variants, **kw):
        calls.append([list(vs) for vs in variants])
        return orig(variants, **kw)

    store.multi_query_search = spy

    def run(r):
        llm = FakeLLM(responses=[trw.QueryVariants(queries=["cars maintenance"])])
        return [d.content for d in trw.RewriteRetriever(
            r, trw.MultiQueryRewriter(llm), top_k=3, k_per_query=4).invoke("automobile upkeep")]

    assert run(tr) == run(_Opaque(tr))
    assert len(calls) == 1 and len(calls[0][0]) == 2  # one fused dispatch


def test_query_variants_is_pydantic():
    assert issubclass(trw.QueryVariants, BaseModel)
    assert trw.QueryVariants.model_json_schema() == jrw.QueryVariants.model_json_schema()
