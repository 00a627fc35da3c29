#!/usr/bin/env bash
# Build + push the GPU container (reference analog: container-alps/build.sh).
set -euo pipefail
TAG=${1:-gb25-gpu:latest}
cd "$(dirname "$0")/.."
docker build -f container/Dockerfile -t "$TAG" .
echo "built $TAG"
echo "push with: docker tag $TAG <registry>/$TAG && docker push <registry>/$TAG"
