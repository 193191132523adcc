"""`python portbench/tests/card_faults.py <change> <portbench.run's arguments>`:
a run of a cell with one change planted in the program first, to read it
at the cell's own size on the card: a fault of test_portbench_reference.py,
or a witness of this file (`program_fp32`: the train traffic with the
program in fp32, TF32 off, where the configuration states bf16).  T0 is
taken before anything is imported, as portbench.run does."""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE]


class _Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def program_fp32(mp):
    from portbench import harness

    real = harness.load_json

    def load_json(*parts):
        out = real(*parts)
        if parts[0] == "traffic" and out.get("kind") == "train":
            out["flags"] = [("--mixed_precision=no" if f.startswith("--mixed_precision=")
                             else f) for f in out["flags"]]
        return out

    mp.setattr(harness, "load_json", load_json)


if __name__ == "__main__":
    import test_portbench_reference as faults
    from portbench import run

    change = globals().get(sys.argv[1]) or getattr(faults, sys.argv[1])
    change(_Patch())
    run.T0 = T0
    sys.exit(run.main(sys.argv[2:]))
