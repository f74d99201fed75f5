"""Feed a collection file into a named pipe from a process of its own, as a
collection streamed from another process would arrive, until a deadline.

    python3 feed.py <collection file> <pipe> <lines a write>

It prints ``ready`` once started, opens the pipe (which waits for the
reader), then reads the deadline,
a ``time.monotonic`` reading, from its standard input, and writes the file
into the pipe a block of lines at a time until the file ends or the
deadline has passed.  It prints the number of lines written.  It imports
nothing of the benchmark, so that it starts fast and shares no
interpreter with the program.
"""

import itertools
import sys
import time


def main(argv) -> int:
    src, pipe, block = argv[0], argv[1], int(argv[2])
    fed = 0
    print("ready", flush=True)
    with open(src, "rb") as f, open(pipe, "wb") as out:
        deadline = float(sys.stdin.readline())
        while time.monotonic() < deadline:
            lines = list(itertools.islice(f, block))
            if not lines:
                break
            out.write(b"".join(lines))
            fed += len(lines)
    print(fed, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
