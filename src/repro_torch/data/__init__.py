"""Offline synthetic datasets (numpy only): the NID flows (``nid``) and the
synthetic LM token stream (``pipeline.SyntheticLM``)."""
