"""One module a loop, found by a traffic file's `loop`: loops/<loop>.py
holds a class Loop(system, arr, traffic, seed) with

  step(keep=True)  one timed unit of the window's work through the
                   system binding (systems/<loop>/<system>.py), its record
                   appended to `records` and its outputs kept for the check
                   (keep=False: set-up's warm-up, nothing kept);
  report()         (tag, object) pairs for standard error after the window;
  release()        drops the system, so the program's state is freed
                   before the reference runs;
  compare(x, reference, config, chips)
                   (numbers, failed, details, work) after the window: the
                   compared numbers, each against LIMITS[name], the steps
                   with any mismatch, what standard error shows, and what
                   the metric readers read of the reference's work;
  LIMITS           the limit of each compared number.

A loop's module names are identifiers (they are imported as modules)."""
