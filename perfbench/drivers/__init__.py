"""Drivers: the system under test as the window drives it, one file
each, found by the ``driver`` of a cell's file
(``perfbench/workloads/<cell>.json``).  ``<driver>.py`` holds a class
``Driver(conf, traffic, seed, device, traced)`` whose constructor is the
set-up (weights, plan, calibration, warm-up), with:

  draw(n)                  the next ``n`` tasks' inputs, from the seed
  record(i, task, due)     a ``harness.window.Record`` (or subclass) for
                           task ``i``
  serve(rec, keep)         serve one task: set ``rec.end`` and ``rec.ok``;
                           keep its outputs for the comparison if ``keep``
  warm_up()                the served shapes again (under the profiler's
                           first start)
  mark()                   the program's counters before the window
  after_window(mark, records, trace_range)
                           (problem, lines, fields): a problem is a broken
                           rule of the window (a capture inside it, a
                           kernel not launched) and ends the run; lines
                           go to standard error; fields join the ``Run``
                           that the metric readers see
  judge(window)            the numbers compared with the cell's limits,
                           after the program's state is freed (``window``
                           is ``harness.window.run``'s result)
"""
