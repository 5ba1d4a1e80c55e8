"""Filter PartiPrompts decision annotations to confident examples
(counterpart of scripts/process_p2_annotations.py; reference
scripts/process_p2_annotations.py). Host-only.

    python -m gill_tpu_torch.scripts.process_p2_annotations \
        --in data/PartiPromptsAllDecisions_Alignment.tsv \
        --out data/PartiPromptsDecisionsConfident.tsv

A row keeps its majority vote when at least 4 of 5 annotators agree, or
3 with at most one dissent; every other row is labelled 'same'. The
header's "Decisions" column becomes "Decision".
"""

from __future__ import annotations

import argparse
import collections


def majority_vote(votes):
    counts = collections.Counter(votes)
    if (counts["gen"] >= 4 or counts["ret"] >= 4) or \
            (counts["gen"] == 3 and counts["ret"] <= 1) or \
            (counts["ret"] == 3 and counts["gen"] <= 1):
        return counts.most_common(1)[0][0]
    return "same"


def filter_annotations(inp: str, out: str) -> collections.Counter:
    """Writes `out` from `inp`; returns the count of each label."""
    with open(inp) as f:
        lines = f.readlines()
    id2vote = {i: majority_vote(lines[i].split("\t")[-1].strip().split(","))
               for i in range(1, len(lines))}
    with open(out, "w") as wf:
        wf.write(lines[0].replace("\tDecisions\n", "\tDecision\n"))
        for i in range(1, len(lines)):
            cols = lines[i].split("\t")[:-1]
            wf.write("\t".join(cols) + f"\t{id2vote[i]}\n")
    return collections.Counter(id2vote.values())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--in", dest="inp",
                   default="data/PartiPromptsAllDecisions_Alignment.tsv")
    p.add_argument("--out",
                   default="data/PartiPromptsDecisionsConfident.tsv")
    args = p.parse_args(argv)
    print(filter_annotations(args.inp, args.out))


if __name__ == "__main__":
    main()
