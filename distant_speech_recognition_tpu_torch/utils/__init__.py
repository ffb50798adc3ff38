"""Host-side helpers (numpy): array geometry, prototypes, WAV I/O."""
