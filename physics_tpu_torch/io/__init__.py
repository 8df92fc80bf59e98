"""Host-side asset helpers."""
