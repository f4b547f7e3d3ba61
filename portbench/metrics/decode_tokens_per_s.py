"""decode_tokens_per_s (tokens/s, host clock): generated tokens of every
request the window served on the float route, over the window's
length."""


def read(data):
    return data["tokens"] / data["window_s"]
