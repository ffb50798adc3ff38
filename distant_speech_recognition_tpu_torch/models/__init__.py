"""Beamforming, postfiltering and the end-to-end enhancement pipeline."""
