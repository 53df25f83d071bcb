"""Launchers: ``serve`` and ``train``, the counterparts of
``repro/launch/serve.py`` and ``repro/launch/train.py``."""
