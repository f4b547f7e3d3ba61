"""ap_tokens_per_s (tokens/s, host clock): generated tokens of every
request the window served on the AP route, over the window's length."""


def read(data):
    return data["tokens"] / data["window_s"]
