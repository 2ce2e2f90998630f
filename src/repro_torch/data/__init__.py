"""Offline synthetic datasets (numpy only)."""
