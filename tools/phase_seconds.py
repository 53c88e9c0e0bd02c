"""Run a command and report the seconds between its phase headers.

    python3 tools/phase_seconds.py [--out FILE] -- python3 chip_smoke.py

The command's standard output passes through unchanged; a line that
starts with ``== `` opens a phase, which lasts until the next such line
or the end.  After the command ends, one JSON object per line follows on
this script's standard output (and in ``FILE`` when given): each phase's
header (its first 60 characters) and seconds on the host clock, then the
command's exit code and total seconds.  The exit code is the command's.
"""
import argparse
import json
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the phases' JSON here")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        ap.error("no command given")
    t0 = time.perf_counter()
    phases = [("(before the first header)", t0)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            bufsize=1)
    for line in proc.stdout:
        sys.stdout.write(line)
        sys.stdout.flush()
        if line.startswith("== "):
            phases.append((line[3:63].rstrip(), time.perf_counter()))
    rc = proc.wait()
    end = time.perf_counter()
    rows = [dict(phase=name, seconds=round(nxt - start, 3))
            for (name, start), (_, nxt) in zip(phases, phases[1:] +
                                               [("", end)])]
    rows.append(dict(rc=rc, total_seconds=round(end - t0, 3)))
    text = "\n".join(json.dumps(r) for r in rows)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
