"""Trial kinds: ``<kind>.py`` is named by a mix file's "trial" key and
defines ``Trials(ctx)`` with:

- ``warm()``: set-up's calls, every shape the cell's traffic uses;
- ``call(i)``: trial i, the timed call of the program's entry point;
- ``note(i, answer)``: what the trial showed (its route, seconds), read
  from the program after it completed; ``depth`` when ``ctx.spans.on``
  or ``ctx.instrumented``;
- ``host(answer)``: the answer as numpy, for the comparison;
- ``key(i)``: the trial's input, so that one reference serves equal ones;
- ``reference(edges, key)`` and ``control(edges, key)``: the plain
  reference's answer and the control's (``portbench.reference``);
- ``gap(answer, reference)``: the number compared for one answer;
- ``work(edges, keys)``: the entries each trial reads, by the yardstick;
- ``CHECK`` and ``LIMIT``: the number's name and its limit.
"""
