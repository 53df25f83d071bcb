"""Launchers.  ``serve`` is the counterpart of ``repro/launch/serve.py``;
the training, dry-run and cell launchers come with ROADMAP item 14."""
