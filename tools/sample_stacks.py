"""Run a Python script under a stack sampler: where its main thread spent
its wall time, by function and by call line.

    python3 tools/sample_stacks.py [--out FILE] SCRIPT [ARGS...]

Every 50 ms a thread reads the main thread's stack.  Each function met on
it (those of SCRIPT and of `repro_torch`) is charged the 50 ms once, and
the innermost four of SCRIPT's frames (``function:line < caller:line``)
are charged as one chain.  The report, written when SCRIPT ends, holds
``wall`` seconds, SCRIPT's exit code ``rc``, ``incl`` (function, seconds)
and ``stacks`` (chain, seconds), each largest first; FILE defaults to
``chiprun_out/sample_stacks.json``.  Child processes are not sampled:
their time is charged to the line that waits on them.
"""
import collections
import json
import os
import runpy
import sys
import threading
import time

PERIOD = 0.05


def main():
    args = sys.argv[1:]
    out = "chiprun_out/sample_stacks.json"
    if args[:1] == ["--out"]:
        out, args = args[1], args[2:]
    script = args[0]
    name = os.path.basename(script)
    sys.argv = args
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    main_id = threading.get_ident()
    incl, stacks = collections.Counter(), collections.Counter()
    done = threading.Event()

    def sample():
        while not done.wait(PERIOD):
            f = sys._current_frames().get(main_id)
            seen, chain = set(), []
            while f is not None:
                where = f.f_code.co_filename
                if name in where or "repro_torch" in where:
                    key = f"{os.path.basename(where)}:{f.f_code.co_name}"
                    if key not in seen:
                        seen.add(key)
                        incl[key] += PERIOD
                    if name in where:
                        chain.append(f"{f.f_code.co_name}:{f.f_lineno}")
                f = f.f_back
            stacks[" < ".join(chain[:4])] += PERIOD

    threading.Thread(target=sample, daemon=True).start()
    t0, rc = time.time(), 0
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        rc = e.code
    finally:
        done.set()
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fh:
            json.dump({"wall": time.time() - t0, "rc": rc,
                       "incl": incl.most_common(300),
                       "stacks": stacks.most_common(300)}, fh, indent=0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
