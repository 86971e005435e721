"""App launcher: start the web UI with gradio-share / localtunnel / ngrok
(counterpart of sesa_tpu/main.py).

    python -m sesa_tpu_torch.main [--method {gradio,localtunnel,ngrok}]
                                  [--port PORT] [--ngrok-token TOKEN]

Functional parity with reference main.py:31-121.
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import threading
import time


def find_free_port(start: int = 7860) -> int:
    for port in range(start, start + 100):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            if s.connect_ex(("127.0.0.1", port)) != 0:
                return port
    raise RuntimeError("no free port found")


def start_gradio(port: int, share: bool = True):
    from sesa_tpu_torch.gui import create_interface

    app = create_interface()
    app.launch(server_port=port, share=share, server_name="0.0.0.0")


def start_localtunnel(port: int):
    """Gradio in the FOREGROUND, the tunnel in the background (reference
    main.py): a tunnel blip or a missing npx must not take down a working
    local UI."""
    from sesa_tpu_torch.gui import create_interface

    app = create_interface()

    def tunnel():
        time.sleep(5)  # let gradio bind the port first
        try:
            # the localtunnel URL asks for a password = the public IP;
            # print it like the reference launcher does
            try:
                import urllib.request

                ip = urllib.request.urlopen(
                    "https://ipv4.icanhazip.com", timeout=10).read().decode().strip()
                print(f"localtunnel password (your public IP): {ip}", flush=True)
            except Exception:
                pass
            p = subprocess.Popen(["npx", "localtunnel", "--port", str(port)],
                                 stdout=subprocess.PIPE, text=True)
            for line in p.stdout:
                print(line, end="", flush=True)
        except FileNotFoundError:
            print("localtunnel requires npx (Node.js); serving locally only",
                  file=sys.stderr)
        except Exception as e:
            print(f"localtunnel failed ({e}); serving locally only",
                  file=sys.stderr)

    threading.Thread(target=tunnel, daemon=True).start()
    app.launch(server_port=port, server_name="0.0.0.0")


def start_ngrok(port: int, token: str):
    try:
        from pyngrok import ngrok
    except ImportError:
        print("ngrok tunnels require the 'pyngrok' package", file=sys.stderr)
        sys.exit(2)
    from sesa_tpu_torch.gui import create_interface

    ngrok.set_auth_token(token)
    tunnel = ngrok.connect(port)
    print(f"ngrok URL: {tunnel.public_url}")
    app = create_interface()
    app.launch(server_port=port, server_name="0.0.0.0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="SESA web UI launcher (PyTorch/CUDA port)")
    p.add_argument("--method", choices=["gradio", "localtunnel", "ngrok"],
                   default="gradio")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--ngrok-token", type=str, default="")
    args = p.parse_args(argv)

    port = args.port or find_free_port()
    if args.method == "gradio":
        start_gradio(port)
    elif args.method == "localtunnel":
        start_localtunnel(port)
    else:
        if not args.ngrok_token:
            print("--ngrok-token is required for the ngrok method", file=sys.stderr)
            return 2
        start_ngrok(port, args.ngrok_token)
    return 0


if __name__ == "__main__":
    sys.exit(main())
