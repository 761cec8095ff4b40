"""Checks of their own, one module per name, for configurations whose
answers `judge.compare` cannot hold to the reference (a configuration's
`"check": "<name>"`), such as a closed loop of many cycles per request.
Each has:

- `NUMBERS`: the names of the numbers it computes, the only names its
  configuration's limits file may give;
- `compare(config, lines, request, answer, *, device) -> dict`: those
  numbers for one sampled answer of the window (`answer` as the entry's
  `answer` gives it);
- optionally `control_answer(config, lines, request, *, dtype, device)`:
  the reference's own answer in the entry's form, which
  `calibrate.py` puts in the program's place (without it, the control is
  `judge.reference_answer`).

A check imports nothing of the program: it works out again what it needs
from the raw request and from the states the program reported, as
`reference/` does.  Its time after the window is paid by every run."""
