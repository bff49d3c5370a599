"""Fused dual-engine kernels: the fleet step (float32 and fixed point) and
the time-fused rollout window."""
