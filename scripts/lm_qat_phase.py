"""Run one of ``chip_smoke.py``'s LM phases alone, on one card: the
lm_qat phase, or the one named (``lm``, ``lm_qat``, ``train``,
``lm_moe``, ``lm_ssm``, ``lm_hybrid``, ``lm_vlm`` or ``lm_encdec``).

Usage, from the root of a checkout (this repo or an unpacked
``git archive`` of another commit, so that two trees can be timed in one
call):
    python3 <path to>/scripts/lm_qat_phase.py [lm | lm_qat | train | lm_moe | lm_ssm |
                                               lm_hybrid | lm_vlm | lm_encdec]

It imports the ``chip_smoke.py`` of the working directory, so the phase
and the package it drives are that checkout's; the kernels are built at
first use.  Prints the phase's lines, then its rows and launches by
kernel and the peak memory allocated.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import chip_smoke as C  # noqa: E402
import torch  # noqa: E402

PHASES = {"lm": C.lm_phase, "lm_qat": C.lm_qat_phase, "train": C.train_phase,
          "lm_moe": C.lm_moe_phase, "lm_ssm": C.lm_ssm_phase, "lm_hybrid": C.lm_hybrid_phase,
          "lm_vlm": C.lm_vlm_phase, "lm_encdec": C.lm_encdec_phase}
name = sys.argv[1] if len(sys.argv) > 1 else "lm_qat"
if name not in PHASES:
    sys.exit(f"unknown phase {name!r}: one of {sorted(PHASES)}")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
print(smi, torch.__version__, torch.version.cuda, flush=True)
out = PHASES[name](torch.device("cuda"), smi)
print({k: len(v) for k, v in out["rows"].items()}, out["launches"])
print("peak", torch.cuda.max_memory_allocated() / 1e9)
