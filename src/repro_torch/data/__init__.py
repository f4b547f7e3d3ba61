from .pipeline import DataCfg, Prefetcher, TokenSource  # noqa: F401
