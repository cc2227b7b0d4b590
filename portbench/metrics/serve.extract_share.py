"""serve.extract_share: the harness's span around Predictor.subgraphs (the
host extraction that predict calls first), summed over the window's
calls and divided by their summed latency, in %."""


def read(layer):
    if layer.get("kind") != "serve" or not layer.get("latency_s"):
        return None
    return 100.0 * layer["extract_s"] / layer["latency_s"]
