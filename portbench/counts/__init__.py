"""Operations and bytes: the model FLOPs of a step or a sampling call, and
the least time each of the four kernels could take for one call."""
