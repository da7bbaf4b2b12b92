"""Real prompt tokens over the token slots the reranker ran (rerank.prompts spans: the length bucket's padding), in %."""

from bench_torch import program_spans


def read(run):
    return program_spans.fill_pct(run, "rerank.prompts")
