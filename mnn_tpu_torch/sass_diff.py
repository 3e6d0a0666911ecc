"""Whether two versions of CUDA sources compile to the same machine code.

    python -m mnn_tpu_torch.sass_diff --against OLD/csrc moe_decode decode_model_b1
    python -m mnn_tpu_torch.sass_diff --common --against OLD/csrc dequant_matmul

Compiles each named `csrc/<name>.cu` of this tree and of another `csrc/`
(`git archive <commit> mnn_tpu_torch/csrc | tar -x -C DIR`, then
`DIR/mnn_tpu_torch/csrc`), each with its own headers, into a cubin for
`sm_90a` with the build's optimisation flags and no line info, all `nvcc`
runs started together. Then it compares, for each source, the instruction
lines of `cuobjdump -sass`: every function's name and every instruction with
its address. The same instructions in the same functions mean that the
kernels give the same bits on the same inputs and launch; it says nothing of
the host code that picks the launch. It prints one line a source and exits
1 if any differ. With `--common` it compares only the functions that both
versions of a source have, function by function (each function's
addresses start at 0), and names those that only one has: a source that
gained kernels still shows whether the ones it kept compile as before.
Needs nvcc and cuobjdump, no card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from mnn_tpu_torch.kernels import build

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
# "        Function : name" and "        /*01a0*/  IADD3 R1, ... ;  /* 0x... */";
# an address has as many hex digits as the function needs (five past 0xffff)
_LINE = re.compile(r"^\s+(Function : \S+|/\*[0-9a-f]+\*/.*)$")
# an anonymous namespace's mangled name holds two hashes of the source, which
# differ between two trees: `47_GLOBAL__N__aa1480e7_14_decode_step_cu_d0c757ef`
_ANON = re.compile(r"(_GLOBAL__N__)[0-9a-f]{8}(_\d+_\w+?_cu_)[0-9a-f]{8}")


def instructions(sass: str) -> list[str]:
    """Function names and instructions of `cuobjdump -sass` output, in order,
    with the second line of each instruction's encoding dropped and the
    hashes of anonymous namespaces blanked."""
    return [_ANON.sub(r"\1########\2########", m.group(1).rstrip())
            for line in sass.splitlines() if (m := _LINE.match(line))]


def functions(lines: list[str]) -> dict[str, list[str]]:
    """`instructions` output -> {function name: its instruction lines}."""
    out: dict[str, list[str]] = {}
    for line in lines:
        if line.startswith("Function : "):
            body = out.setdefault(line[len("Function : "):], [])
        else:
            body.append(line)
    return out


def compare_common(this: list[str], other: list[str]) -> tuple[list[str], list[str], list[str],
                                                                list[str]]:
    """(functions both have with the same instructions, both have with other
    instructions, only `this` has, only `other` has), each sorted."""
    a, b = functions(this), functions(other)
    both = sorted(a.keys() & b.keys())
    return ([f for f in both if a[f] == b[f]], [f for f in both if a[f] != b[f]],
            sorted(a.keys() - b.keys()), sorted(b.keys() - a.keys()))


def compile_all(names, csrc_dirs, out: Path) -> None:
    nvcc = build._nvcc()
    cmds = [[nvcc, *FLAGS, "-I", str(d), "-cubin", "-o", str(out / f"{n}.{i}.cubin"),
             str(d / f"{n}.cu")]
            for i, d in enumerate(csrc_dirs) for n in names]
    build._run_all(cmds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, required=True, help="another csrc/ directory")
    ap.add_argument("--common", action="store_true",
                    help="compare only the functions both versions of a source have")
    ap.add_argument("names", nargs="+", help="sources of csrc/, without .cu")
    args = ap.parse_args()
    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    differ = False
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        compile_all(args.names, (build.CSRC, args.against.resolve()), out)
        for n in args.names:
            this, other = (instructions(subprocess.run(
                [cuobjdump, "-sass", str(out / f"{n}.{i}.cubin")], check=True,
                capture_output=True, text=True).stdout) for i in (0, 1))
            funcs = sum(x.startswith("Function : ") for x in this)
            if args.common:
                same, diff, mine, theirs = compare_common(this, other)
                differ = differ or bool(diff)
                print(f"sass {n}: {len(same)} common functions the same, {len(diff)} "
                      f"different{': ' + ', '.join(diff) if diff else ''}; "
                      f"{len(mine)} only in this tree, {len(theirs)} only in the other")
                continue
            if this == other:
                print(f"sass {n}: same ({len(this) - funcs} instructions in {funcs} functions)")
                continue
            differ = True
            at = next((i for i, (a, b) in enumerate(zip(this, other)) if a != b),
                      min(len(this), len(other)))
            print(f"sass {n}: DIFFERENT ({len(this) - funcs} against "
                  f"{len(other) - sum(x.startswith('Function : ') for x in other)} "
                  f"instructions; first difference at line {at})")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
