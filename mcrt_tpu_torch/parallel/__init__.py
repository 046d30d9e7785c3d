"""The renderer's training step (one device; multi-device is not ported yet)."""
