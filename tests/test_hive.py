"""Hive connector tests: parquet write -> scan round trip, row-group
splits, column pruning, string dictionaries, filters."""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from velox_tpu.connectors.hive import register_hive
from velox_tpu.exec.task import Task
from velox_tpu.testing.plan_builder import PlanBuilder


@pytest.fixture()
def hive(tmp_path):
    conn = register_hive("hive")
    conn._base = str(tmp_path)
    return conn


def sample_df(n=5000, seed=5):
    rng = np.random.RandomState(seed)
    return pd.DataFrame({
        "k": rng.randint(0, 100, n).astype("int64"),
        "v": rng.randn(n),
        "s": rng.choice(["red", "green", "blue", "cyan"], n),
        "d": np.array(rng.randint(8000, 12000, n), dtype="datetime64[D]"),
    })


def test_scan_round_trip(hive, tmp_path):
    df = sample_df()
    # write with small row groups to get multiple splits per file
    pq.write_table(pa.table(df.iloc[:3000]),
                   tmp_path / "part-0.parquet", row_group_size=1000)
    pq.write_table(pa.table(df.iloc[3000:]),
                   tmp_path / "part-1.parquet", row_group_size=1000)
    t = hive.register_table("t", str(tmp_path))
    assert len(t.splits()) == 5  # 3 + 2 row groups

    plan = (PlanBuilder()
            .table_scan("t", ["k", "v", "s"], connector_id="hive")
            .plan())
    got = Task(plan).run().to_pandas().sort_values(
        ["k", "v"]).reset_index(drop=True)
    exp = df[["k", "v", "s"]].sort_values(["k", "v"]).reset_index(drop=True)
    np.testing.assert_array_equal(got.k, exp.k)
    np.testing.assert_allclose(got.v, exp.v, rtol=1e-6)
    np.testing.assert_array_equal(got.s, exp.s)


def test_scan_with_filter_and_agg(hive, tmp_path):
    df = sample_df()
    pq.write_table(pa.table(df), tmp_path / "t.parquet",
                   row_group_size=1024)
    hive.register_table("t2", str(tmp_path / "t.parquet"))
    plan = (PlanBuilder()
            .table_scan("t2", ["k", "s"], connector_id="hive",
                        filter="s = 'red'")
            .single_aggregation([], ["count() as n"])
            .plan())
    got = Task(plan).run().to_pandas()
    assert got.n[0] == (df.s == "red").sum()


def test_table_writer(hive, tmp_path):
    df = sample_df(1000)
    out_path = str(tmp_path / "out" / "data.parquet")
    plan = (PlanBuilder()
            .values([pa.table(df)])
            .filter("k < 50")
            .table_write(out_path, connector_id="hive")
            .plan())
    got = Task(plan).run().to_pandas()
    assert got.rows[0] == (df.k < 50).sum()
    assert got.bytes[0] > 0
    back = pq.read_table(out_path).to_pandas()
    assert len(back) == (df.k < 50).sum()
    assert (back.k < 50).all()


def test_string_dictionary_order(hive, tmp_path):
    """Ordered string comparisons work in dictionary-id space."""
    df = sample_df(2000)
    pq.write_table(pa.table(df), tmp_path / "t.parquet")
    hive.register_table("t3", str(tmp_path / "t.parquet"))
    plan = (PlanBuilder()
            .table_scan("t3", ["s"], connector_id="hive")
            .filter("s > 'cyan'")  # green, red
            .single_aggregation([], ["count() as n"])
            .plan())
    got = Task(plan).run().to_pandas()
    assert got.n[0] == (df.s > "cyan").sum()


def test_partitioned_write_and_read(tmp_path):
    import numpy as np
    import pandas as pd
    from velox_tpu.connectors.hive import register_hive
    rng = np.random.RandomState(4)
    df = pd.DataFrame({
        "region": rng.choice(["eu", "us", "ap"], 200),
        "year": rng.choice([2023, 2024], 200).astype("int64"),
        "v": rng.randint(0, 1000, 200).astype("int64"),
    })
    root = str(tmp_path / "sales")
    plan = (PlanBuilder().values([pa.table(df)])
            .table_write(root, partition_keys=["region", "year"]).plan())
    out = Task(plan).run().to_pandas()
    assert out.rows[0] == 200
    # hive directory layout: region=eu/year=2023/part-0.parquet
    import glob as g
    files = g.glob(root + "/region=*/year=*/*.parquet")
    assert len(files) == df.groupby(["region", "year"]).ngroups
    # partition columns are NOT in the file data
    import pyarrow.parquet as pq
    assert "region" not in pq.read_schema(files[0]).names
    # read back through the connector: partition dirs -> columns
    conn = register_hive("hive-part-test")
    conn.register_table("sales", root)
    rplan = (PlanBuilder()
             .table_scan("sales", ["region", "year", "v"],
                         connector_id="hive-part-test")
             .plan())
    got = Task(rplan).run().to_pandas()
    assert len(got) == 200
    assert got.v.sum() == df.v.sum()
    gg = got.groupby(["region", "year"]).v.sum().to_dict()
    for (r, y), s in df.groupby(["region", df.year.astype(str)]).v.sum() \
            .to_dict().items():
        assert gg[(r, y)] == s


def test_bucketed_write(tmp_path):
    import glob as g
    import numpy as np
    import pandas as pd
    df = pd.DataFrame({"k": np.arange(100, dtype="int64"),
                       "v": np.arange(100, dtype="int64")})
    root = str(tmp_path / "bkt")
    plan = (PlanBuilder().values([pa.table(df)])
            .table_write(root, bucket_count=4, bucket_keys=["k"]).plan())
    Task(plan).run()
    files = sorted(g.glob(root + "/*.parquet"))
    assert 1 < len(files) <= 4
    import pyarrow.parquet as pq
    total = sum(pq.read_table(f).num_rows for f in files)
    assert total == 100
    # same key always lands in the same bucket file (deterministic hash)
    plan2 = (PlanBuilder().values([pa.table(df)])
             .table_write(str(tmp_path / "bkt2"), bucket_count=4,
                          bucket_keys=["k"]).plan())
    Task(plan2).run()
    files2 = sorted(g.glob(str(tmp_path / "bkt2") + "/*.parquet"))
    for f1, f2 in zip(files, files2):
        assert pq.read_table(f1).column("k").to_pylist() == \
            pq.read_table(f2).column("k").to_pylist()


def test_row_group_stats_pruning(tmp_path):
    import numpy as np
    import pandas as pd
    import pyarrow.parquet as pq
    from velox_tpu.common import metrics as M
    from velox_tpu.connectors.hive import register_hive
    # three files with disjoint value ranges -> a range filter must prune
    root = tmp_path / "t"
    root.mkdir()
    for i, lo in enumerate((0, 1000, 2000)):
        df = pd.DataFrame({"x": np.arange(lo, lo + 100, dtype="int64"),
                           "v": np.ones(100, dtype="int64")})
        pq.write_table(pa.table(df), str(root / f"f{i}.parquet"))
    conn = register_hive("hive-prune-test")
    conn.register_table("t", str(root))
    plan = (PlanBuilder()
            .table_scan("t", ["x", "v"], connector_id="hive-prune-test",
                        filter="x >= 1000 and x < 1050")
            .single_aggregation([], ["count(*) as c", "sum(x) as s"])
            .plan())
    before = M.reporter().snapshot()["counters"].get(
        M.K_SPLITS_PRUNED, 0)
    out = Task(plan).run().to_pylist()
    pruned = M.reporter().snapshot()["counters"].get(
        M.K_SPLITS_PRUNED, 0) - before
    assert out[0]["c"] == 50
    assert out[0]["s"] == sum(range(1000, 1050))
    assert pruned == 2  # files f0 and f2 skipped by stats


def test_partition_pruning_via_stats(tmp_path):
    import numpy as np
    import pandas as pd
    from velox_tpu.connectors.hive import register_hive
    df = pd.DataFrame({
        "region": ["eu"] * 50 + ["us"] * 50,
        "v": np.arange(100, dtype="int64")})
    root = str(tmp_path / "p")
    plan = (PlanBuilder().values([pa.table(df)])
            .table_write(root, partition_keys=["region"]).plan())
    Task(plan).run()
    conn = register_hive("hive-prune2-test")
    conn.register_table("p", root)
    plan2 = (PlanBuilder()
             .table_scan("p", ["region", "v"],
                         connector_id="hive-prune2-test",
                         filter="region = 'eu'")
             .single_aggregation([], ["count(*) as c"]).plan())
    out = Task(plan2).run().to_pylist()
    assert out[0]["c"] == 50


def test_custom_filesystem_scan(tmp_path):
    """Storage-adapter path: scan through an explicit pyarrow filesystem
    (SubTreeFileSystem stands in for S3/GCS — same code path as
    FileSystem.from_uri resolution)."""
    import numpy as np
    import pandas as pd
    import pyarrow.parquet as pq
    from pyarrow import fs as pafs
    from velox_tpu.connectors.hive import register_hive
    df = pd.DataFrame({"x": np.arange(50, dtype="int64")})
    (tmp_path / "d").mkdir()
    pq.write_table(pa.table(df), str(tmp_path / "d" / "f.parquet"))
    sub = pafs.SubTreeFileSystem(str(tmp_path), pafs.LocalFileSystem())
    conn = register_hive("hive-fs-test")
    conn.register_table("t", "d", filesystem=sub)
    plan = (PlanBuilder().table_scan("t", ["x"],
                                     connector_id="hive-fs-test")
            .single_aggregation([], ["sum(x) as s", "count(*) as c"])
            .plan())
    out = Task(plan).run().to_pylist()
    assert out[0] == {"s": sum(range(50)), "c": 50}


def test_unreachable_remote_uri_raises():
    import pytest
    from velox_tpu.connectors.hive import register_hive
    conn = register_hive("hive-bad-uri")
    with pytest.raises(Exception):
        conn.register_table("t", "badscheme://bucket/path")


def test_grouped_execution(tmp_path):
    """GroupedTask over a bucketed table: per-group pipelines produce the
    same result as one monolithic run (parity: velox grouped execution,
    exec/Task.h:151)."""
    import numpy as np
    import pandas as pd
    from velox_tpu.connectors.hive import register_hive
    from velox_tpu.exec.task import GroupedTask
    rng = np.random.RandomState(7)
    df = pd.DataFrame({"k": rng.randint(0, 40, 400).astype("int64"),
                       "v": rng.randint(0, 100, 400).astype("int64")})
    root = str(tmp_path / "bt")
    Task(PlanBuilder().values([pa.table(df)])
         .table_write(root, bucket_count=4, bucket_keys=["k"])
         .plan()).run()
    conn = register_hive("hive-grouped-test")
    conn.register_table("t", root)
    plan = (PlanBuilder()
            .table_scan("t", ["k", "v"], connector_id="hive-grouped-test")
            .single_aggregation(["k"], ["sum(v) as s", "count(*) as c"])
            .plan())
    gt = GroupedTask(plan)
    got = gt.run().to_pandas().sort_values("k").reset_index(drop=True)
    assert gt.n_groups > 1
    assert len(gt.group_tasks) == gt.n_groups
    exp = (df.groupby("k").agg(s=("v", "sum"), c=("v", "count"))
           .reset_index())
    assert got.k.tolist() == exp.k.tolist()
    assert got.s.tolist() == exp.s.tolist()
    assert got.c.tolist() == exp.c.tolist()


def test_grouped_execution_join_with_mixed_scan(tmp_path):
    """Bucketed probe side + unbucketed (broadcast) build side."""
    import numpy as np
    import pandas as pd
    from velox_tpu.connectors.hive import register_hive
    from velox_tpu.exec.task import GroupedTask
    probe = pd.DataFrame({"k": np.arange(100, dtype="int64") % 10,
                          "v": np.arange(100, dtype="int64")})
    dim = pd.DataFrame({"dk": np.arange(10, dtype="int64"),
                        "name": np.arange(10, dtype="int64") * 1000})
    proot, droot = str(tmp_path / "p"), str(tmp_path / "d")
    Task(PlanBuilder().values([pa.table(probe)])
         .table_write(proot, bucket_count=3, bucket_keys=["k"])
         .plan()).run()
    Task(PlanBuilder().values([pa.table(dim)])
         .table_write(droot + "/f.parquet").plan()).run()
    conn = register_hive("hive-grouped-join")
    conn.register_table("probe", proot)
    conn.register_table("dim", droot)
    b = PlanBuilder()
    bb = (b.new_builder()
          .table_scan("dim", ["dk", "name"],
                      connector_id="hive-grouped-join"))
    plan = (b.table_scan("probe", ["k", "v"],
                         connector_id="hive-grouped-join")
            .hash_join(["k"], ["dk"], bb, output=["k", "v", "name"])
            .plan())
    got = GroupedTask(plan).run().to_pandas()
    exp = probe.merge(dim, left_on="k", right_on="dk")
    assert len(got) == len(exp)
    assert got.v.sum() == exp.v.sum()
    assert got.name.sum() == exp.name.sum()


def test_lazy_per_column_dictionaries(tmp_path):
    """Scanning only numeric columns must not pay the distinct pass for
    unrelated high-cardinality string columns (VERDICT weak #6)."""
    import numpy as np
    import pandas as pd
    from velox_tpu.connectors.hive import register_hive
    n = 5000
    df = pd.DataFrame({
        "k": np.arange(n, dtype="int64"),
        "comment": [f"unique comment number {i}" for i in range(n)],
        "seg": [f"s{i % 3}" for i in range(n)],
    })
    path = str(tmp_path / "t.parquet")
    Task(PlanBuilder().values([pa.table(df)])
         .table_write(path).plan()).run()
    conn = register_hive("hive-lazydict")
    conn.register_table("t", path)
    out = (PlanBuilder().table_scan("t", ["k"],
                                    connector_id="hive-lazydict")
           .single_aggregation([], ["sum(k) as s"]).plan())
    got = Task(out).run()
    assert got.column("s")[0].as_py() == df.k.sum()
    tbl = conn._tables["t"]
    built = tbl._dictionaries or {}
    assert "comment" not in built          # never requested -> never built
    # now a scan that needs `seg` builds only `seg`
    out2 = (PlanBuilder().table_scan("t", ["k", "seg"],
                                     connector_id="hive-lazydict")
            .single_aggregation(["seg"], ["count() as c"]).plan())
    got2 = Task(out2).run()
    assert got2.num_rows == 3
    built = tbl._dictionaries
    assert "seg" in built and "comment" not in built
