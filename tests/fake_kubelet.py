"""A kubelet of one for tests/fake_k8s.FakeK8s (a test double).

`run_pod` runs one replica of a materialized Deployment on this host: its
main container's command, args and env as a child process, with the
downward API's fields filled in (`status.podIP`, `metadata.name`) and each
Service URL in the env rewritten to where that Service's pod listens here
(the cluster's DNS and Service routing, which a host's loopback has not:
two pods that would each bind port 8000 on their own IP are given their
own ports). The Pod object, with the template's labels and its podIP, is
put in the fake apiserver, so the controller finds it as it would a
scheduled pod (drain victims, rollouts, quarantine). `python3` in the
command runs this interpreter. Jax-free: the port's on-card smoke test
uses it too.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional


class Pod:
    """A running pod: its process, its log (a temporary file) and the
    Pod object in the fake apiserver."""

    def __init__(self, fake, namespace: str, obj: dict, proc, log):
        self.fake, self.namespace, self.obj = fake, namespace, obj
        self.proc, self.log = proc, log
        self.name = obj["metadata"]["name"]
        self.ip = obj["status"]["podIP"]

    def alive(self) -> bool:
        return self.proc.poll() is None

    def tail(self, n: int = 3000) -> str:
        self.log.seek(0)
        return self.log.read().decode(errors="replace")[-n:]

    def stop(self, timeout: float = 15.0) -> Optional[int]:
        """SIGTERM (the pod's graceful drain), then SIGKILL after
        `timeout`; the Pod object leaves the fake apiserver."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=timeout)
        self.log.close()
        with self.fake.store.lock:
            self.fake.store._bucket("v1", self.namespace, "pods").pop(
                self.name, None)
        return self.proc.returncode


def container_env(container: dict, pod_ip: str, pod_name: str,
                  services: Dict[str, str]) -> Dict[str, str]:
    """The container's env as the kubelet would set it: literal values
    (each Service URL prefix in `services` rewritten to its local address)
    and the downward API's podIP and name."""
    fields = {"status.podIP": pod_ip, "metadata.name": pod_name}
    out = {}
    for e in container.get("env") or []:
        if "value" in e:
            v = str(e["value"])
            for svc, local in services.items():
                v = v.replace(svc, local)
            out[e["name"]] = v
        else:
            ref = ((e.get("valueFrom") or {}).get("fieldRef") or {}).get(
                "fieldPath")
            if ref not in fields:
                raise NotImplementedError(
                    f"env {e['name']}: the kubelet of one fills only "
                    f"{sorted(fields)}")
            out[e["name"]] = fields[ref]
    return out


def run_pod(fake, dep: dict, pod_ip: str = "127.0.0.1",
            services: Optional[Dict[str, str]] = None,
            env: Optional[Dict[str, str]] = None,
            cwd: Optional[str] = None) -> Pod:
    """Start the first replica of Deployment `dep` (as the fake apiserver
    holds it), pod `<dep>-0`. `env` adds to the container's env (a port
    the pod would own on its IP, say); the process inherits this one's
    environment as the image's."""
    meta = dep["metadata"]
    namespace = meta.get("namespace", "default")
    template = dep["spec"]["template"]
    container = template["spec"]["containers"][0]
    name = f"{meta['name']}-0"
    cmd = list(container.get("command") or []) + list(
        container.get("args") or [])
    if not cmd:
        raise ValueError(f"{meta['name']}: the container runs nothing")
    if cmd[0] == "python3":
        cmd[0] = sys.executable
    proc_env = dict(os.environ)
    proc_env.update(container_env(container, pod_ip, name, services or {}))
    proc_env.update(env or {})
    log = tempfile.TemporaryFile()
    proc = subprocess.Popen(cmd, cwd=cwd, env=proc_env, stdout=log,
                            stderr=subprocess.STDOUT)
    obj = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {
            "name": name, "namespace": namespace,
            "labels": dict(template["metadata"].get("labels") or {}),
            "creationTimestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime()),
        },
        "spec": template["spec"],
        "status": {"phase": "Running", "podIP": pod_ip},
    }
    fake.put_object("v1", namespace, "pods", obj)
    return Pod(fake, namespace, obj, proc, log)
