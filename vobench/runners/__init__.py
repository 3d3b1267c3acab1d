"""Runners of the program's entry points, one module per kind of unit
that a traffic file names under "runner". Each module defines `Runner`,
built from the run's context (vobench.run.Context), with:

    setup()            the program's objects and every warm-up step
    run_unit(it)       one unit of the timed path, its nav outputs read
                       back to the host: (frames done, frames whose
                       position is finite, per-frame latencies in s or
                       None)
    state()            the program's carried state as host copies of
                       canonical named leaves (vobench.check); the
                       embedded system adds its own (sys.*)
    outputs()          the last unit's outputs, likewise
    unit(it)           the frames unit `it` stepped, per lane, and the
                       time of the frame before them
    start_frames()     the frames set-up stepped, per lane, bootstrap
                       first
    extras(units)      what a metric reads beyond the trace, for the
                       given units
    close()            release the program's objects
"""
