"""setup_s (s, host clock): process start to the first timed request:
kernel build or load, weights made and quantized, engine, warm-up."""


def read(data):
    return data["setup_s"]
