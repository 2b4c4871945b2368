"""Model flops of one task, one file per kind of architecture, from the
configuration's widths: each weight used once per token, the head on the
last token only (the served split classifies from it)."""
