"""NeuFlow's pieces that NeuFlow v2 reuses; the model is not ported yet."""
