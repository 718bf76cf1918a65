"""GMFlow: only the sine position embedding is ported so far."""
