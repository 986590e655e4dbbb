"""Render the dry-run JSON into the roofline tables: the port of
``repro.launch.report`` (pure Python, the same text).

    PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.json
"""
import json
import sys


def fmt_bytes(b):
    return f"{b/1e9:.2f}"


def render(results: dict) -> str:
    lines = []
    lines.append(
        "| arch | shape | mesh | t_compute s | t_memory s | t_mem(kernel) s"
        " | t_coll s | bottleneck | useful | roofline | roofline(kernel) |"
        " peak GB/dev |"
    )
    lines.append("|" + "---|" * 12)
    skips = []
    for key in sorted(results):
        v = results[key]
        arch, shape, mesh = key.split("|")
        if v.get("status") == "skipped":
            skips.append((arch, shape, mesh, v["reason"]))
            continue
        if v.get("status") != "ok":
            lines.append(f"| {arch} | {shape} | {mesh} | ERROR |" + " |" * 8)
            continue
        lines.append(
            f"| {arch} | {shape} | {mesh} "
            f"| {v['t_compute']:.3f} | {v['t_memory']:.3f} "
            f"| {v['t_memory_kernel_adj']:.3f} | {v['t_collective']:.3f} "
            f"| {v['bottleneck']} | {v['useful_flops_ratio']:.2f} "
            f"| {v['roofline_fraction']:.3f} "
            f"| {v['roofline_fraction_kernel_adj']:.3f} "
            f"| {v['memory_per_device']['peak_bytes_per_device']/1e9:.2f} |"
        )
    lines.append("")
    lines.append("Skipped cells (documented, DESIGN.md SS4):")
    lines.append("")
    for arch, shape, mesh, reason in skips:
        lines.append(f"- `{arch} x {shape} x {mesh}` — {reason}")
    return "\n".join(lines)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    with open(path) as f:
        print(render(json.load(f)))


if __name__ == "__main__":
    main()
