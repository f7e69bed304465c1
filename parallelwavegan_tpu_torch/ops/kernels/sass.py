"""What the kernel sources compile to: per kernel, its SASS instruction
count and its tensor-core (HMMA for mma.sync, HGMMA for wgmma) and fused
multiply-add (FFMA) counts, and,
against a second source tree, which kernels' SASS is identical;
``resource_usage`` gives one source's registers and spills (``ptxas
-v``) beside those counts.

Needs nvcc and cuobjdump (the CUDA toolkit), so it runs where the card is:
    python -m parallelwavegan_tpu_torch.ops.kernels.sass [--against DIR]
DIR is another tree's ``csrc`` directory (a parent commit unpacked with
``git archive``). Each source is compiled by itself to a cubin with the
flags of ``build.py``, all at once, into a temporary directory. Names in
the anonymous namespace carry a per-file hash, which is cut before two
trees are compared; so are addresses and encodings. A kernel that gained
a last ``bool`` template argument for a bf16 mode (``tade1_kernel<kSave,
kBF16>``) is compared, at ``false``, with the other tree's kernel without
it (``tade1_kernel<kSave>``), and one that lost it (``stage_bwd_kernel<D>``)
with the other tree's at ``false``.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import tempfile

from parallelwavegan_tpu_torch.ops.kernels import build


def _cut_anon(name: str) -> str:
    """A mangled name with its anonymous namespace (``_ZN<length>
    _GLOBAL__N__...``, named after the file) replaced by ANON."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N__", name)
    if not m:
        return name
    return "_ZNANON" + name[m.end(1) + int(m.group(1)):]


def compile_cubins(csrc: str, out_dir: str) -> dict:
    """{source name: cubin path} for every ``*.cu`` in csrc."""
    nvcc = build._nvcc()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for src in build.sources(csrc):
        name = os.path.basename(src)
        cubin = os.path.join(out_dir, f"{name}.cubin")
        procs[name] = (cubin, subprocess.Popen(
            [nvcc, *flags, "-cubin", "-o", cubin, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (cubin, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = cubin
    return out


def kernels_of(cubin: str) -> dict:
    """{kernel name, anonymous-namespace hash cut: [instructions]}."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _cut_anon(m.group(1))
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def counts(instrs: list) -> str:
    ops = [i.split()[1] if i.startswith("@") else i.split()[0] for i in instrs]
    n = {k: sum(op.startswith(k) for op in ops) for k in ("HMMA", "HGMMA", "FFMA")}
    out = f"{len(instrs)} instructions"
    for k in ("HMMA", "HGMMA"):
        kinds = sorted({op for op in ops if op.startswith(k)})
        if k == "HMMA" or kinds:
            out += f", {k} {n[k]}{' (' + ', '.join(kinds) + ')' if kinds else ''}"
    return out + f", FFMA {n['FFMA']}"


def short_name(mangled: str) -> str:
    """A kernel's name and integer and bool template arguments out of its
    mangled name: ``_ZN..9dz_kernelILi128EEEv..`` -> ``dz_kernel<128>``,
    ``..20wavenet_layer_kernelILi64ELb1EEEv..`` -> ``wavenet_layer_kernel<64,
    true>``."""
    name = _cut_anon(mangled)
    rest = name[len("_ZNANON"):] if name.startswith("_ZNANON") else name.lstrip("_Z")
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    n = int(m.group(1))
    base, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if not args:
        return base
    vals = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in re.findall(r"L([ib])(\d+)E", args.group(1))]
    return f"{base}<{', '.join(vals)}>"


def without_bf16_flag(short: str) -> str | None:
    """A short name whose last template argument is ``false`` without it
    (``tade1_kernel<true, false>`` -> ``tade1_kernel<true>``,
    ``stage_wgrad_kernel<false>`` -> ``stage_wgrad_kernel``), else None."""
    m = re.match(r"(.*?)(?:<(.*), )?(?:<)?false>$", short)
    if not m:
        return None
    base, rest = m.group(1), m.group(2)
    return f"{base}<{rest}>" if rest else base


def resource_usage(source: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads" (bytes), "sass"
    (``counts``)}} of one kernel source, compiled by itself with the flags
    of ``build.py`` into a temporary cubin (nvcc and cuobjdump needed)."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-cubin", "-o", cubin,
                               source], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
        out, entry = {}, None
        for line in (proc.stdout + proc.stderr).splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                entry = short_name(m.group(1))
                out[entry] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                out[entry]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and entry:
                out[entry]["spill_stores"] = int(m.group(1))
                out[entry]["spill_loads"] = int(m.group(2))
        for name, instrs in kernels_of(cubin).items():
            out.setdefault(short_name(name), {})["sass"] = counts(instrs)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another tree's csrc directory")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "a"))
        mine = compile_cubins(build.CSRC, os.path.join(tmp, "a"))
        other = {}
        if args.against:
            os.makedirs(os.path.join(tmp, "b"))
            other = compile_cubins(args.against, os.path.join(tmp, "b"))
        for src, cubin in mine.items():
            ks = kernels_of(cubin)
            theirs = kernels_of(other[src]) if src in other else None
            by_short = {}
            for k, v in (theirs or {}).items():
                by_short[short_name(k)] = v
                if without_bf16_flag(short_name(k)):
                    by_short.setdefault(without_bf16_flag(short_name(k)), v)
            for name in sorted(ks):
                note = ""
                if theirs is not None:
                    old = theirs.get(name)
                    if old is None:
                        old = by_short.get(short_name(name))
                    if old is None:
                        old = by_short.get(without_bf16_flag(short_name(name)))
                    note = ("; not in the other tree" if old is None else
                            "; SASS identical to the other tree's" if old == ks[name]
                            else "; SASS differs from the other tree's")
                print(f"SASS {src} {name}: {counts(ks[name])}{note}")


if __name__ == "__main__":
    main()
