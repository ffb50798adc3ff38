"""Offline filterbank prototype design (numpy)."""
