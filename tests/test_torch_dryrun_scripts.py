"""The port's dry-run scripts on the CPU (fake tensors, the fake backend):
``scripts/perf_iterations_torch.py`` and
``scripts/make_experiments_tables_torch.py``.

- One tagged iteration (hymba_1_5b ``prefill_32k`` ``it2_chunk2048``, an
  ``attn_chunk_threshold`` override) writes its record beside the
  cheapest supported cell's baseline record (olmoe_1b_7b
  ``prefill_32k``), and prints the note that the override is inert in
  the port; its counts equal the same cell traced without the override.
- The table script prints the baseline, roofline and iteration tables
  from those records: trace s from ``lower_s``, temp and peak GB, the
  torch version; it refuses a directory whose records name two torch
  versions (exit 2).
"""

import contextlib
import io
import json

import pytest
import torch

from repro_torch.launch import dryrun
from torch_entry_points import load
from torch_threads import one_torch_thread  # noqa: F401

DRY = "results/dryrun"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The records' directory, the iteration's printed text and numbers,
    and the same cell traced without the override."""
    root = tmp_path_factory.mktemp("dryrun_scripts")
    iters = load("scripts/perf_iterations_torch.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        base = dryrun.run_cell("olmoe_1b_7b", "prefill_32k", False,
                               out_dir=DRY, device="cpu")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            nums = iters.main(["it2_chunk2048", "--device", "cpu"])
    plain = dryrun.run_cell("hymba_1_5b", "prefill_32k", False, device="cpu")
    return root / DRY, buf.getvalue(), nums, base, plain


def test_iteration_prints_the_inert_override_note(records):
    path, text, nums, _, plain = records
    iters = load("scripts/perf_iterations_torch.py")
    assert list(nums) == ["hymba_1_5b it2_chunk2048"]
    got = nums["hymba_1_5b it2_chunk2048"]
    assert got["status"] == "ok" and got["note"] == iters.ATTN_CHUNK_NOTE
    assert "== hymba_1_5b prefill_32k [it2_chunk2048]" in text
    assert f"  note: {iters.ATTN_CHUNK_NOTE}" in text
    rec = json.loads(
        (path / "hymba_1_5b_prefill_32k_16x16_it2_chunk2048.json").read_text())
    assert rec["tag"] == "it2_chunk2048"
    assert rec["plan"]["microbatches"] == plain["plan"]["microbatches"]
    for key in ("cost", "collectives", "memory"):
        assert rec[key] == plain[key], key
    assert iters.note_for("it1_ssmchunk", {}) == iters.SCAN_CHUNK_NOTE
    assert iters.note_for("it1_micro4", {"microbatches": 4}) == ""


def test_tables_from_the_port_records(records, capsys):
    path, _, nums, base, _ = records
    tables = load("scripts/make_experiments_tables_torch.py")
    out = tables.main([str(path)])
    text = capsys.readouterr().out
    assert out["torch"] == torch.__version__
    assert text.startswith(f"Dry-run records of torch {torch.__version__}")
    assert "| arch | shape | mesh | status | trace s | temp GB | peak GB |" \
        in text
    [row] = out["baseline"]
    assert row["arch"] == "olmoe_1b_7b" and row["status"] == "ok"
    assert row["trace_s"] == base["lower_s"]
    assert row["peak_gb"] == base["memory"]["peak_bytes"] / 1e9
    assert row["temp_gb"] == base["memory"]["temp_bytes"] / 1e9
    assert f"| {base['lower_s']} | " \
        f"{base['memory']['temp_bytes'] / 1e9:.2f} | " \
        f"{base['memory']['peak_bytes'] / 1e9:.2f} |" in text
    [roof] = out["roofline"]
    assert roof["roofline_fraction"] == \
        base["roofline"]["roofline_fraction"]
    [it] = out["iterations"]
    assert it["tag"] == "it2_chunk2048"
    assert it["compute_s"] == nums["hymba_1_5b it2_chunk2048"]["compute_s"]
    assert "| it2_chunk2048 | hymba_1_5b | prefill_32k |" in text
    assert out["final"] == []


def test_tables_refuse_two_torch_versions(records, tmp_path, capsys):
    path = records[0]
    for src in path.glob("*.json"):
        (tmp_path / src.name).write_text(src.read_text())
    other = json.loads(next(path.glob("olmoe*.json")).read_text())
    other.update(tag="old", torch="2.11.0+cu128")
    (tmp_path / "olmoe_1b_7b_prefill_32k_16x16_old.json").write_text(
        json.dumps(other))
    tables = load("scripts/make_experiments_tables_torch.py")
    with pytest.raises(SystemExit) as exc:
        tables.main([str(tmp_path)])
    assert exc.value.code == 2
    captured = capsys.readouterr()
    assert "2.11.0+cu128" in captured.err and torch.__version__ in captured.err
    assert captured.out == ""
