"""Serving package: the REST server (``app``, ``http``), the online
predict tier (``batcher``), the multi-process front end (``frontend``)
and the row channel (``rowchannel``).

``App`` and ``Server`` are lazy attributes (PEP 562) rather than eager
imports: the catalog imports ``rowchannel`` from this package and must
not pull ``app``'s device stack in with it."""


def __getattr__(name):
    if name == "App":
        from learningorchestra_tpu_torch.serving.app import App

        return App
    if name == "Server":
        from learningorchestra_tpu_torch.serving.http import Server

        return Server
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
