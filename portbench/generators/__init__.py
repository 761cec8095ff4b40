"""Generators of their own, one module per name, for configurations whose
requests `generate.draw_pool` does not draw (a configuration's
`"generator": "<name>"`).  Each has `draw_pool(config, mix, seed) ->
(lines, pool)`: what the entry is built over, and the requests the window
sends in order.  A generator draws from the seed with plain NumPy and
imports nothing of the program, as `generate.py` does."""
