"""The harness's own pieces: data, counts, spans, traces, weights."""
