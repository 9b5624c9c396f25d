"""A loopback stand-in for PubMLST's allele designations call.

    python3 bench_port/mlst_service.py PROFILES

serves ``POST <scheme URL>/designations`` on 127.0.0.1, at a port the
operating system picks, which it prints as the first line of its
standard output.  ``PROFILES`` is a profile table as PubMLST gives it
(tab-separated: a header ``ST`` and the loci, then one line an ST).  A
request's designations (``{"designations": {locus: [{"allele": "n"}]}}``)
that name every locus of a profile in the table get ``{"fields": {"ST":
"<st>"}}``; any other gets 200 with no ``fields``.  It stops when its
standard input closes, which happens when the process that started it
exits.  It resolves no names and imports nothing but the standard
library.

:class:`Service` starts one in a process of its own.
"""

import json
import socketserver
import subprocess
import sys
import threading
import weakref
from http.server import BaseHTTPRequestHandler
from pathlib import Path


def read_profiles(path) -> tuple:
    """``(loci, {allele numbers in locus order: ST})`` of a profile table."""
    lines = Path(path).read_text(encoding="utf-8").splitlines()
    header = lines[0].split("\t")
    if header[0] != "ST":
        raise ValueError(f"{path}: a profile table starts with the column ST, not {header[0]!r}")
    table = {}
    for line in lines[1:]:
        st, *alleles = line.split("\t")
        table[tuple(int(a) for a in alleles)] = st
    return header[1:], table


def write_profiles(path, loci: list, profiles: dict) -> None:
    """Write ``{allele numbers: ST}`` as a profile table."""
    rows = ["\t".join(["ST", *loci])]
    rows += ["\t".join([str(st), *(str(a) for a in alleles)]) for alleles, st in profiles.items()]
    Path(path).write_text("\n".join(rows) + "\n", encoding="utf-8")


class _Designations(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def _reply(self, payload: dict, status: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if not self.path.endswith("/designations"):
            return self._reply({"message": f"no route {self.path}"}, 404)
        try:
            designations = json.loads(body)["designations"]
            alleles = tuple(int(designations[locus][0]["allele"]) for locus in self.server.loci)
        except (ValueError, KeyError, IndexError, TypeError):
            return self._reply({"message": "no exact match"})
        st = self.server.table.get(alleles)
        if st is None:
            return self._reply({"message": "no exact match"})
        return self._reply({"fields": {"ST": st}})


class _Server(socketserver.ThreadingMixIn, socketserver.TCPServer):
    # a TCPServer binds the address as given: unlike http.server's, it
    # looks no name up
    daemon_threads = True


def serve(profiles) -> None:
    """Serve ``profiles`` until standard input reaches its end."""
    loci, table = read_profiles(profiles)
    with _Server(("127.0.0.1", 0), _Designations) as server:
        server.loci, server.table = loci, table
        print(server.server_address[1], flush=True)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        sys.stdin.read()
        server.shutdown()
        thread.join(timeout=5)


def _stop(proc: subprocess.Popen) -> None:
    proc.stdin.close()
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5)
    proc.stdout.close()


class Service:
    """The service in a process of its own, serving ``profiles``; stopped
    by :meth:`stop`, when the object is collected, or at exit."""

    def __init__(self, profiles):
        self._proc = subprocess.Popen([sys.executable, "-I", str(Path(__file__).resolve()), str(profiles)],
                                      stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.stop = weakref.finalize(self, _stop, self._proc)
        line = self._proc.stdout.readline()
        if not line.strip().isdigit():
            self.stop()
            raise RuntimeError(f"the designations service did not start (exit code {self._proc.poll()})")
        self.url = f"http://127.0.0.1:{int(line)}"


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__.split("\n\n")[1])
    serve(sys.argv[1])
