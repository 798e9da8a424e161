"""What one pass of a traffic mix runs, and how its outputs are judged:
``benchmark/commands/<command>.py`` for a traffic's ``command``.

A command module gives ``one_pass(runner, path, outdir, timers)`` (one
pass over the file at ``path``; with ``timers``, the traced form),
``judge(cell, corpus, results, passes_run, outdir)`` (the numbers
compared, each ``{"value", "limit"}``, and the passes that failed) and
``control(cell, corpus, outdir)`` (the same numbers for the control)."""
