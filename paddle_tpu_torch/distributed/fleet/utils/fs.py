"""Filesystem clients (the JAX package's `fleet/utils/fs.py`, the
port's own copy; reference: fleet/utils/fs.py + framework/io/fs.cc).

LocalFS wraps the host filesystem; HDFSClient shells out to the hadoop
CLI exactly like the reference (fs.cc pipes `hadoop fs -ls` etc through
popen). The command prefix is configurable so GCS (`gsutil`) or a test
shim can substitute — the shell-pipe framework IS the capability; no
egress happens unless the operator provides a working client binary.
"""
from __future__ import annotations

import os
import shutil
import subprocess


class ExecuteError(RuntimeError):
    pass


class LocalFS:
    """fleet/utils/fs.py LocalFS parity."""

    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for n in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, n))
             else files).append(n)
        return dirs, files

    def is_exist(self, path):
        return os.path.exists(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src, dst):
        os.rename(src, dst)

    def mv(self, src, dst, overwrite=False):
        if overwrite:
            self.delete(dst)
        elif os.path.exists(dst):
            raise ExecuteError(
                f"mv: {dst!r} exists (pass overwrite=True to replace)")
        os.rename(src, dst)

    def upload(self, local_path, path, multi_processes=1,
               overwrite=False):
        if overwrite:
            self.delete(path)
        shutil.copy(local_path, path)

    def download(self, path, local_path, multi_processes=1,
                 overwrite=False):
        if overwrite and os.path.exists(local_path):
            os.remove(local_path)
        shutil.copy(path, local_path)

    def touch(self, path, exist_ok=True):
        if os.path.exists(path) and not exist_ok:
            raise ExecuteError(f"{path} exists")
        open(path, "a").close()

    def cat(self, path):
        with open(path, "rb") as f:
            return f.read()


class HDFSClient:
    """Shell-pipe HDFS/remote-store client (fs.cc HDFS command parity).

    hadoop_home/configs follow the reference constructor; `cmd_prefix`
    overrides the executable (e.g. ["gsutil"] for GCS-style stores or a
    test shim script).
    """

    def __init__(self, hadoop_home=None, configs=None, cmd_prefix=None,
                 time_out=5 * 60 * 1000, sleep_inter=1000):
        if cmd_prefix is not None:
            self._base = list(cmd_prefix)
        else:
            exe = os.path.join(hadoop_home, "bin", "hadoop") \
                if hadoop_home else "hadoop"
            self._base = [exe, "fs"]
            for k, v in (configs or {}).items():
                self._base += ["-D", f"{k}={v}"]
        self._timeout = time_out / 1000.0

    def _run(self, *args, check=True):
        cmd = self._base + list(args)
        try:
            # binary pipes: cat must pass bytes through untouched
            p = subprocess.run(cmd, capture_output=True,
                               timeout=self._timeout)
        except FileNotFoundError as e:
            raise ExecuteError(
                f"remote-fs client binary not found: {cmd[0]!r} — install "
                f"the hadoop/gsutil CLI or pass cmd_prefix") from e
        except subprocess.TimeoutExpired as e:
            raise ExecuteError(f"{' '.join(cmd)} timed out") from e
        if check and p.returncode != 0:
            err = p.stderr.decode("utf-8", "replace").strip()[:500]
            raise ExecuteError(
                f"{' '.join(cmd)} failed rc={p.returncode}: {err}")
        return p

    def ls_dir(self, path):
        p = self._run("-ls", path, check=False)
        dirs, files = [], []
        for line in p.stdout.decode("utf-8", "replace").splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rstrip("/").split("/")[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, path):
        return self._run("-test", "-e", path,
                         check=False).returncode == 0

    def is_dir(self, path):
        return self._run("-test", "-d", path,
                         check=False).returncode == 0

    def is_file(self, path):
        return self.is_exist(path) and not self.is_dir(path)

    def mkdirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        self._run("-rm", "-r", "-f", path, check=False)

    def mv(self, src, dst, overwrite=False):
        if overwrite:
            self.delete(dst)
        self._run("-mv", src, dst)

    def upload(self, local_path, path, multi_processes=1, overwrite=False):
        if overwrite:
            self.delete(path)
        self._run("-put", local_path, path)

    def download(self, path, local_path, multi_processes=1,
                 overwrite=False):
        if overwrite and os.path.exists(local_path):
            os.remove(local_path)
        self._run("-get", path, local_path)

    def touch(self, path, exist_ok=True):
        if not exist_ok and self.is_exist(path):
            raise ExecuteError(f"{path} exists")
        self._run("-touchz", path)

    def cat(self, path):
        return self._run("-cat", path).stdout  # bytes, like LocalFS.cat
